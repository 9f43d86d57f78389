"""Plain float32 Wan 2.1 DiT (Wan's model.py, with Self-Forcing's block-causal
KV cache), the int8 tier's calibration and quantisation, and the few-step
flow-matching denoise of one serving block.

The weights come from `gpubench.weights`, a layer at a time; each layer is
drawn once and kept quantised (integer quanta as int8 tensors, f32 scales).
Everything computes in float32 with TF32 off.

What the configuration states, and this file follows:
  * the block linears (self q/k/v fused, o, cross q/k/v/o, ffn fc1/fc2) hold
    per-output-channel weight quanta; every one but cross k/v quantises its
    input with a static scale calibrated on the serving schedule (the cross
    k/v product runs once per prompt on the dequantised weights);
  * with `int8_qk`, the attention's q and k are quantised per row (k minus
    its segment mean) and the logits are the integer products times the two
    scales (`quant.py`);
  * the serving KV cache holds (kv frames + one block) frames, is zeroed at
    every block, prefilled from the clean context at t = 0 and attended over
    whole, the zero rows included where the int8 QK^T means read them.

Calibration (the program's recipe, drawn again here): normal latents
[1, 3, 16, 16, 16], one per denoise timestep, and a normal context [1, 512,
text_dim] from a generator seeded with the load seed, on the run's device;
each a decode forward at current_start 3 frames of a 6-frame zeroed cache
(so the first 3 frames' zero keys take part); amax per site over them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gpubench import weights
from gpubench.reference import quant

SITES = ("qkv", "o", "cq", "co", "fc1", "fc2")


# ---------------------------------------------------------------------------
# schedule and positions
# ---------------------------------------------------------------------------


class Schedule:
    """The shifted flow-matching table (1000 steps, sigma_min 0, one extra
    step), timesteps looked up by nearest neighbour."""

    def __init__(self, shift: float):
        s = np.linspace(1.0, 0.0, 1001, dtype=np.float32)[:-1]
        s = shift * s / (1 + (shift - 1) * s)
        self.sigmas = s.astype(np.float32)
        self.timesteps = (self.sigmas * 1000).astype(np.float32)

    def sigma(self, t: float) -> float:
        return float(self.sigmas[int(np.argmin(np.abs(self.timesteps - np.float32(t))))])

    def steps(self, n: int, strength: float = 1.0) -> List[float]:
        table = np.concatenate([self.timesteps, np.zeros(1, np.float32)])
        idx = np.linspace(strength * 1000, 0, n, dtype=np.float32).astype(np.int64)
        return [float(t) for t in table[1000 - idx]]


def rope(head_dim: int, f: int, h: int, w: int, start: int, device):
    """(cos, sin) [f*h*w, head_dim/2] of the 3D RoPE, the head dim split
    [t | h | w] = [d - 4(d//6), 2(d//6), 2(d//6)], theta 10000."""
    d = head_dim
    parts = []
    for dim, n, off in ((d - 4 * (d // 6), f, start), (2 * (d // 6), h, 0), (2 * (d // 6), w, 0)):
        inv = 1.0 / np.power(10000.0, np.arange(0, dim, 2, dtype=np.float64) / dim)
        parts.append(np.outer(np.arange(off, off + n, dtype=np.float64), inv))
    at, ah, aw = parts
    grid = np.concatenate([
        np.broadcast_to(at[:, None, None, :], (f, h, w, at.shape[1])),
        np.broadcast_to(ah[None, :, None, :], (f, h, w, ah.shape[1])),
        np.broadcast_to(aw[None, None, :, :], (f, h, w, aw.shape[1]))], -1).reshape(f * h * w, -1)
    return (torch.tensor(np.cos(grid), dtype=torch.float32, device=device),
            torch.tensor(np.sin(grid), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs of x [B, L, N, D]."""
    b, L, n, d = x.shape
    xr = x.reshape(b, L, n, d // 2, 2)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([xr[..., 0] * c - xr[..., 1] * s,
                        xr[..., 0] * s + xr[..., 1] * c], -1).reshape(b, L, n, d)


def sinusoid(dim: int, t: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    inv = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=t.device) / half)
    arg = t.float().reshape(-1)[:, None] * inv[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], 1)


def layer_norm(x, eps, scale=None, bias=None):
    mu = x.mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention(q, k, v, lo: int, hi: int, int8_qk: bool, qmax: int,
              heads_per_chunk: int = 4) -> torch.Tensor:
    """q [B, Lq, N, D] over the live keys [lo, hi) of k, v [B, Lk, N, D];
    with int8_qk the keys' segment means are taken over the whole k, as
    the kernel reads the whole cache window."""
    d = q.shape[-1]
    scale = d ** -0.5
    if int8_qk:
        seg = quant.segment_rows(k.shape[1])
        q8, sq = quant.quantize_rows(q * (scale * quant.LOG2E), qmax)
        k8, sk = quant.quantize_rows(quant.centred_keys(k, seg), qmax)
        k8, sk = k8[:, lo:hi], sk[:, lo:hi]
    kk, vv = k[:, lo:hi], v[:, lo:hi]
    outs = []
    for h0 in range(0, q.shape[2], heads_per_chunk):
        hs = slice(h0, h0 + heads_per_chunk)
        if int8_qk:
            s2 = torch.einsum("bqnd,bknd->bnqk", q8[:, :, hs], k8[:, :, hs])
            s2 = s2 * sq[:, :, hs, 0].permute(0, 2, 1)[..., None] \
                * sk[:, :, hs, 0].permute(0, 2, 1)[:, :, None, :]
            p = torch.exp2(s2 - s2.amax(-1, keepdim=True))
        else:
            s = torch.einsum("bqnd,bknd->bnqk", q[:, :, hs], kk[:, :, hs]) * scale
            p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bnqk,bknd->bqnd", p, vv[:, :, hs])
        outs.append(o / p.sum(-1).permute(0, 2, 1)[..., None])
        del p
    return torch.cat(outs, 2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class WanDiT:
    """The DiT of config `cfg` with the weights of `seed` and `key` (0: the
    run's DiT; another key: another DiT of the process, as `weights` draws
    it), on `device`. qmax: 127 (int8), 7 (int4, the control) or None
    (float, no quanta). Call `calibrate` before any quantised forward."""

    def __init__(self, cfg: dict, seed: int, device, qmax: Optional[int] = 127,
                 int8_qk: bool = False, shift: float = 5.0, key: int = 0):
        self.cfg, self.seed, self.device, self.key = cfg, seed, torch.device(device), key
        self.qmax, self.int8_qk = qmax, int8_qk
        self.schedule = Schedule(shift)
        top = weights.dit_top(cfg, seed, self.device, key)
        self.top = {k: v.float() for k, v in top.items()}
        self.amax: Optional[Dict[str, List[float]]] = None
        self._layers: Dict[int, dict] = {}

    # -- weights --------------------------------------------------------------

    def float_layer(self, i: int) -> dict:
        raw = {k: v.float() for k, v in weights.dit_layer(self.cfg, self.seed, i,
                                                          self.device, self.key).items()}
        g = lambda *p: raw[p]  # noqa: E731
        lin = lambda grp, n: (g(grp, n, "w"), g(grp, n, "b"))  # noqa: E731
        qkv_w = torch.cat([g("self_attn", n, "w") for n in "qkv"], 1)
        qkv_b = torch.cat([g("self_attn", n, "b") for n in "qkv"], 0)
        return {"qkv": (qkv_w, qkv_b), "o": lin("self_attn", "o"),
                "cq": lin("cross_attn", "q"), "ck": lin("cross_attn", "k"),
                "cv": lin("cross_attn", "v"), "co": lin("cross_attn", "o"),
                "fc1": lin("ffn", "fc1"), "fc2": lin("ffn", "fc2"),
                "norm_q": g("self_attn", "norm_q", "scale"),
                "norm_k": g("self_attn", "norm_k", "scale"),
                "cnorm_q": g("cross_attn", "norm_q", "scale"),
                "cnorm_k": g("cross_attn", "norm_k", "scale"),
                "modulation": g("modulation"), "norm3": (g("norm3", "scale"), g("norm3", "bias"))}

    def quantize(self, lw: dict, i: int) -> dict:
        """Layer i's float weights lw as the tier holds them: quanta (int8
        storage), scales and the static input scales of its sites."""
        lw = dict(lw)
        for name in SITES + ("ck", "cv"):
            w, b = lw[name]
            wq, s = quant.weight_quanta(w, self.qmax)
            a = (None if name in ("ck", "cv") else
                 quant.act_scale(self.amax[name][i], self.qmax))
            lw[name] = (wq.to(torch.int8), s, b, a)
        return lw

    def layer(self, i: int) -> dict:
        """Layer i as the tier holds it (float without quanta)."""
        if self.qmax is None:
            return self.float_layer(i)
        if i not in self._layers:
            self._layers[i] = self.quantize(self.float_layer(i), i)
        return self._layers[i]

    def linear(self, lw: dict, name: str, x: torch.Tensor, record=None) -> torch.Tensor:
        p = lw[name]
        if record is not None:
            record.setdefault(name, []).append(float(x.abs().amax()))
        if len(p) == 2:  # float
            return x @ p[0] + p[1]
        wq, s, b, a = p
        if a is not None:
            x = quant.fake_quant_act(x, a, self.qmax)
        return (x @ wq.float()) * s + b

    # -- pieces ------------------------------------------------------------

    def text_context(self, emb: torch.Tensor) -> torch.Tensor:
        """The text embedding MLP of the prompt embedding [1, T, text_dim]."""
        t = self.top
        ctx = gelu_tanh(emb @ t[("text_embedding", "fc1", "w")] + t[("text_embedding", "fc1", "b")])
        return ctx @ t[("text_embedding", "fc2", "w")] + t[("text_embedding", "fc2", "b")]

    def text_kv(self, lw: dict, ctx: torch.Tensor):
        """A layer's cross-attention K/V [1, T, N, Dh] of the text context."""
        cfg = self.cfg
        k = rms_norm(self.linear(lw, "ck", ctx), lw["cnorm_k"], cfg["eps"])
        v = self.linear(lw, "cv", ctx)
        n, dh = cfg["num_heads"], cfg["dim"] // cfg["num_heads"]
        return k.reshape(k.shape[0], -1, n, dh), v.reshape(v.shape[0], -1, n, dh)

    def cross_kv(self, emb: torch.Tensor) -> list:
        """Every layer's text K/V of a prompt embedding (once per prompt)."""
        ctx = self.text_context(emb)
        return [self.text_kv(self.layer(i), ctx) for i in range(self.cfg["num_layers"])]

    def time(self, t: torch.Tensor):
        """t [B] -> (e [B, D], e0 [B, 6, D])."""
        tp = self.top
        sin = sinusoid(self.cfg["freq_dim"], t)
        e = F.silu(sin @ tp[("time_embedding", "fc1", "w")] + tp[("time_embedding", "fc1", "b")])
        e = e @ tp[("time_embedding", "fc2", "w")] + tp[("time_embedding", "fc2", "b")]
        e0 = F.silu(e) @ tp[("time_projection", "fc", "w")] + tp[("time_projection", "fc", "b")]
        return e, e0.reshape(-1, 6, self.cfg["dim"])

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        b, f, c, hh, ww = x.shape
        xt = x.reshape(b, f, c, hh // 2, 2, ww // 2, 2).permute(0, 1, 3, 5, 2, 4, 6)
        tokens = xt.reshape(b, f * (hh // 2) * (ww // 2), c * 4)
        return tokens @ self.top[("patch_embedding", "w")] + self.top[("patch_embedding", "b")]

    def head(self, x, e, grid):
        f, h, w = grid
        b = x.shape[0]
        eh = self.top[("head", "modulation")][None] + e[:, None, None, :]  # [B, 1, 2, D]
        y = layer_norm(x, self.cfg["eps"]).reshape(b, f, h * w, -1)
        y = y * (1 + eh[:, :, 1][:, :, None]) + eh[:, :, 0][:, :, None]
        out = y.reshape(b, f * h * w, -1) @ self.top[("head", "head", "w")] \
            + self.top[("head", "head", "b")]
        c = self.cfg["out_dim"]
        out = out.reshape(b, f, h, w, 1, 2, 2, c).permute(0, 1, 4, 7, 2, 5, 3, 6)
        return out.reshape(b, f, c, h * 2, w * 2)

    # -- one forward ---------------------------------------------------------

    def forward(self, x, t: torch.Tensor, start_frame: int, cross, attend, record=None,
                layer=None, done=None):
        """x [B, F, C, H, W] f32 at timesteps t [B]; `attend(i, q, k, v)` is
        layer i's self-attention (it may write a cache); `cross` every
        layer's text K/V, or a function (i, layer weights) of them. `layer(i)`
        gives layer i's weights (default `self.layer`); `done(i, weights)`
        runs after layer i. Returns the flow [B, F, C, H, W]."""
        cfg = self.cfg
        b, f = x.shape[:2]
        grid = (f, x.shape[3] // 2, x.shape[4] // 2)
        fsl = grid[1] * grid[2]
        n, dh = cfg["num_heads"], cfg["dim"] // cfg["num_heads"]
        cos, sin = rope(dh, *grid, start_frame, self.device)
        tokens = self.patchify(x)
        e, e0 = self.time(t)
        L = tokens.shape[1]

        def mod(z, shift, scale):
            z = z.reshape(b, f, fsl, -1) * (1 + scale[:, None, None]) + shift[:, None, None]
            return z.reshape(b, L, -1)

        def gate(z, g):
            return (z.reshape(b, f, fsl, -1) * g[:, None, None]).reshape(b, L, -1)

        for i in range(cfg["num_layers"]):
            lw = (layer or self.layer)(i)
            em = lw["modulation"][0][None] + e0  # [B, 6, D]
            xn = mod(layer_norm(tokens, cfg["eps"]), em[:, 0], em[:, 1])
            q, k, v = self.linear(lw, "qkv", xn, record).chunk(3, -1)
            q = apply_rope(rms_norm(q, lw["norm_q"], cfg["eps"]).reshape(b, L, n, dh), cos, sin)
            k = apply_rope(rms_norm(k, lw["norm_k"], cfg["eps"]).reshape(b, L, n, dh), cos, sin)
            y = attend(i, q, k, v.reshape(b, L, n, dh)).reshape(b, L, -1)
            tokens = tokens + gate(self.linear(lw, "o", y, record), em[:, 2])
            xc = layer_norm(tokens, cfg["eps"], *lw["norm3"])
            qc = rms_norm(self.linear(lw, "cq", xc, record), lw["cnorm_q"], cfg["eps"])
            ck, cv = cross(i, lw) if callable(cross) else cross[i]
            yc = attention(qc.reshape(b, L, n, dh), ck.expand(b, -1, -1, -1),
                           cv.expand(b, -1, -1, -1), 0, ck.shape[1], self.int8_qk,
                           self.qmax or 127)
            tokens = tokens + self.linear(lw, "co", yc.reshape(b, L, -1), record)
            xf = mod(layer_norm(tokens, cfg["eps"]), em[:, 3], em[:, 4])
            h = gelu_tanh(self.linear(lw, "fc1", xf, record))
            tokens = tokens + gate(self.linear(lw, "fc2", h, record), em[:, 5])
            if done is not None:
                done(i, lw)
        return self.head(tokens, e, grid)

    # -- calibration -----------------------------------------------------------

    def calibrate(self, steps: List[float], load_seed: int, lat: int = 16, kv_frames: int = 6,
                  nfpb: int = 3) -> None:
        """Per-(site, layer) input amax over the float decode forwards at each
        timestep (plus t = 0 if the list lacks it), drawn as the program draws
        them; then the layers are quantised from these scales."""
        cfg = self.cfg
        ts = list(steps)
        if not ts or ts[-1] != 0.0:
            ts.append(0.0)
        gen = torch.Generator(device=self.device).manual_seed(load_seed)
        noisy = [torch.randn((1, nfpb, cfg["in_dim"], lat, lat), generator=gen,
                             device=self.device) for _ in ts]
        context = torch.randn((1, cfg["text_len"], cfg["text_dim"]), generator=gen,
                              device=self.device)
        qmax, self.qmax = self.qmax, None
        fsl = (lat // 2) ** 2
        size, start = kv_frames * fsl, (kv_frames - nfpb) * fsl
        ctx = self.text_context(context)
        record: dict = {}
        L = cfg["num_layers"]
        self.amax = {s: [0.0] * L for s in SITES}
        self._layers.clear()

        def attend(i, q, k, v):  # each forward's rows [0, start) of the cache stay 0
            kc = torch.zeros((k.shape[0], size) + k.shape[2:], device=self.device)
            vc = torch.zeros_like(kc)
            kc[:, start:start + k.shape[1]] = k
            vc[:, start:start + v.shape[1]] = v
            return attention(q, kc, vc, 0, size, self.int8_qk, qmax or 127)

        def done(i, lw):  # layer i's scales are known: quantise it now
            for site in SITES:
                self.amax[site][i] = record[site][i]
            if qmax is not None:
                self.qmax = qmax
                self._layers[i] = self.quantize(lw, i)
                self.qmax = None

        # the forwards are independent: one batch
        self.forward(torch.cat(noisy), torch.tensor(ts, device=self.device), start // fsl,
                     lambda i, lw: self.text_kv(lw, ctx), attend, record,
                     layer=self.float_layer, done=done)
        self.qmax = qmax

    # -- one serving block ------------------------------------------------------

    def block(self, emb: torch.Tensor, noisy: torch.Tensor, draws: List[torch.Tensor],
              steps: List[float], context: Optional[torch.Tensor], kv_frames: int = 3,
              cross: Optional[list] = None):
        """One session block: zero the cache, prefill it from the clean
        context latents [1, Fc, C, H, W] (if any) at t = 0, then the few-step
        denoise of noisy [1, nfpb, C, H, W], renoising with draws[i] after
        step i; `cross` is the prompt's text K/V where already made. Returns
        x0 [1, nfpb, C, H, W] f32."""
        cfg = self.cfg
        nl = cfg["num_layers"]
        cross = self.cross_kv(emb) if cross is None else cross
        nfpb = noisy.shape[1]
        fsl = (noisy.shape[3] // 2) * (noisy.shape[4] // 2)
        size = (kv_frames + nfpb) * fsl
        n, dh = cfg["num_heads"], cfg["dim"] // cfg["num_heads"]
        kc = torch.zeros((nl, 1, size, n, dh), device=self.device)
        vc = torch.zeros_like(kc)
        model_start = 0
        if context is not None:
            lc = context.shape[1] * fsl

            def prefill(i, q, k, v):  # the context is one block: dense
                kc[i, :, :lc], vc[i, :, :lc] = k, v
                return attention(q, k, v, 0, lc, self.int8_qk, self.qmax or 127)

            self.forward(context, torch.zeros(1, device=self.device), 0, cross, prefill)
            model_start = min(context.shape[1], kv_frames)
        cur = model_start * fsl
        x = noisy
        for j, t in enumerate(steps):
            def decode(i, q, k, v):
                kc[i, :, cur:cur + q.shape[1]], vc[i, :, cur:cur + q.shape[1]] = k, v
                return attention(q, kc[i], vc[i], 0, cur + q.shape[1], self.int8_qk,
                                 self.qmax or 127)

            flow = self.forward(x, torch.full((1,), t, device=self.device), model_start,
                                cross, decode)
            x0 = x - self.schedule.sigma(t) * flow
            if j < len(steps) - 1:
                sn = self.schedule.sigma(steps[j + 1])
                x = (1 - sn) * x0 + sn * draws[j]
        return x0


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
