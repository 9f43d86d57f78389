"""Block-causal Wan DiT in PyTorch, bf16 tier (port of realtime_video_tpu/models/wan_dit.py).

Parameters are a plain nested dict of tensors in the JAX package's layout:
transformer blocks stacked on a leading layer axis, linear weights `w` as
[in, out], so a JAX parameter tree converts leaf by leaf
(`utils/convert.py`). The forward is a Python loop over layers; the KV cache
(`ops/kv_cache.py`) is written in place. Attention modes:

  * "decode": RoPE offset current_start // fsl; K/V appended at the
    reference's local indices; attention over the window
    [local_end - max_attention_size, local_end) (causal_model.py:349-392);
  * "prefill": K/V written at [0, L), blockwise-causal attention over the
    input (causal_model.py:305-348 + the serving recompute path);
  * "train": no cache; full attention over the input, or under a dense
    `attn_mask` on the CPU (the 50-step teacher and the bidirectional
    samplers, text2video.py's generate).

AdaLN modulation is per frame ([B, F, 6, C], causal_model.py:463-491).
Numerics as in the JAX package: params and activations bf16, norms, RoPE and
the time MLP in f32. Attention goes through `ops/attention.py`.

Two tiers of block linears, chosen by the parameters:
  * bf16 (`w`): plain `torch.matmul`, as the JAX package leaves them to `jnp.dot`;
  * int8 (`w_q` [in, out] s8, stored [out, in] so that the kernel reads it
    K-major (`hopper_int8_mm.k_major`), `scale` [out] f32 per output
    channel, `a_scale` a static per-tensor activation scale, or none for a
    per-call amax):
    `quantize_wan_linears` makes them, `calibrate_wan_act_scales` folds the
    calibration records that `dit_forward(act_calib=...)` collects, and
    `linear` runs them through the fused int8 kernel
    (`ops/hopper_int8_mm.py`) on a card, or its plain version on the CPU.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from realtime_video_tpu_torch.config import WanModelConfig
from realtime_video_tpu_torch.models.rope import (
    RopeTables,
    rope_apply_fused,
    sinusoidal_embedding_1d,
)
from realtime_video_tpu_torch.ops import attention as attn_ops
from realtime_video_tpu_torch.ops import hopper_int8_mm
from realtime_video_tpu_torch.ops import kv_cache as kvc

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def linear(p: Params, x: torch.Tensor, record: Optional[list] = None) -> torch.Tensor:
    """x @ w + b. On int8 weights (`w_q`): quantise x per tensor with the
    static `a_scale`, or with max|x| / 127 taken on the device when there is
    none, then the s8 product and the dequantising epilogue in one kernel
    (wan_dit.py:84-126 of the JAX package). `record`, when given, collects
    max|x| of a float linear for activation calibration."""
    if record is not None and "w" in p:
        record.append(x.float().abs().amax())
    if "w_q" in p:
        a_scale = p["a_scale"] if "a_scale" in p else hopper_int8_mm.dynamic_scale(x)
        return hopper_int8_mm.int8_linear(x, p["w_q"], p["scale"], a_scale, p.get("b"))
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _calib_site_order(blocks: Params) -> List[Tuple[str, str]]:
    """The block-linear call order inside one layer of dit_forward (self-attn
    projection(s), o, cross q, cross o, ffn fc1, fc2)."""
    sa = blocks["self_attn"]
    sites = ([("self_attn", "qkv")] if "qkv" in sa else
             [("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v")])
    sites += [("self_attn", "o"), ("cross_attn", "q"), ("cross_attn", "o"),
              ("ffn", "fc1"), ("ffn", "fc2")]
    return sites


def calibrate_wan_act_scales(records: List[torch.Tensor], blocks: Params,
                             num_layers: int) -> Dict[Tuple[str, str], torch.Tensor]:
    """Fold call-order calibration records (one per block linear per layer,
    over >= 1 forwards) into {(group, name): [L] amax}, float64 on the CPU;
    several forwards are max-reduced elementwise."""
    sites = _calib_site_order(blocks)
    per_fwd = num_layers * len(sites)
    if not records or len(records) % per_fwd:
        raise ValueError(f"{len(records)} calibration records do not tile "
                         f"{num_layers} layers x {len(sites)} sites")
    arr = torch.stack([r.reshape(()) for r in records]).double().cpu()
    amax = arr.reshape(-1, num_layers, len(sites)).amax(dim=0)  # [L, sites]
    return {site: amax[:, j] for j, site in enumerate(sites)}


def quantize_wan_linears(params: Params, act_scales: Optional[dict] = None,
                         margin: float = 1.5) -> Params:
    """int8-quantise the transformer block linears (self/cross attention
    projections and FFN) with per-output-channel weight scales, in torch on the
    parameters' device (wan_dit.py:182-242 of the JAX package). Sites in
    `act_scales` ({(group, name): [L] amax}) get a static per-layer activation
    scale amax * margin / 127; the rest quantise with a per-call amax.

    Each stacked weight is quantised a layer at a time: the f32 temporaries of
    a whole [L, in, out] stack (11 GB for the 14B's fc1) would not fit beside
    the model on an 80 GB card. The quanta are those of the whole-stack form.
    Each `w_q` is the [L, in, out] view of [L, out, in] storage, the fused
    int8 kernel's K-major layout (`hopper_int8_mm.k_major`)."""

    def quant(p, a_amax=None):
        w = p["w"]  # [L, in, out]
        wq = torch.empty((w.shape[0], w.shape[2], w.shape[1]), dtype=torch.int8,
                         device=w.device).transpose(1, 2)
        scale = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32, device=w.device)
        for i in range(w.shape[0]):
            wl = w[i].float()
            amax = torch.clamp(wl.abs().amax(dim=0), min=1e-8)
            # a tensor divisor: on a card PyTorch divides by a Python scalar as
            # a multiply by its reciprocal, not the IEEE quotient numpy gives
            scale[i] = amax / torch.full_like(amax, 127.0)
            wq[i] = torch.clamp(torch.round(wl / scale[i]), -127, 127)
        out = {"w_q": wq, "scale": scale}
        if a_amax is not None:
            # float64 on the host, as numpy computes the JAX package's scale
            a = torch.as_tensor(a_amax, dtype=torch.float64, device="cpu")
            out["a_scale"] = (torch.clamp(a, min=1e-6) * margin / 127.0).to(
                device=w.device, dtype=torch.float32)
        if "b" in p:
            out["b"] = p["b"]
        return out

    def is_linear(v):
        return isinstance(v, dict) and "w" in v and v["w"].dim() == 3

    def walk(node, group):
        if is_linear(node):
            return quant(node)
        if not isinstance(node, dict):
            return node
        return {k: quant(v, act_scales[(group, k)])
                if act_scales and (group, k) in act_scales and is_linear(v)
                else walk(v, group) for k, v in node.items()}

    blocks = params["blocks"]
    new_blocks = dict(blocks)
    for key in ("self_attn", "cross_attn", "ffn"):
        new_blocks[key] = walk(blocks[key], key)
    if act_scales and not any(isinstance(v, dict) and "a_scale" in v
                              for g in ("self_attn", "cross_attn", "ffn")
                              for v in new_blocks[g].values()):
        # calibrated on another layout (e.g. unfused q/k/v, then fused)
        raise ValueError("act_scales matched no linear: calibrate and quantise on the "
                         f"same param layout (scale keys: {sorted(act_scales)})")
    return dict(params, blocks=new_blocks)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """WanRMSNorm (model.py:69-85): stats in f32, then * weight."""
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return n.to(x.dtype) * p["scale"].to(x.dtype)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """WanLayerNorm (model.py:88-98): f32 stats, optional affine."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def modulate(x: torch.Tensor, num_frames: int, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """Per-frame AdaLN: x [B, L, D] viewed as [B, F, L/F, D];
    x * (1 + scale) + shift (causal_model.py:471)."""
    b, L, d = x.shape
    xf = x.reshape(b, num_frames, L // num_frames, d)
    y = xf * (1.0 + scale[:, :, None, :].to(x.dtype)) + shift[:, :, None, :].to(x.dtype)
    return y.reshape(b, L, d)


def gate(x: torch.Tensor, num_frames: int, g: torch.Tensor) -> torch.Tensor:
    b, L, d = x.shape
    xf = x.reshape(b, num_frames, L // num_frames, d)
    return (xf * g[:, :, None, :].to(x.dtype)).reshape(b, L, d)


# ---------------------------------------------------------------------------
# parameter init / structure
# ---------------------------------------------------------------------------


def _init_linear(gen, shape_in_out, dtype, device, init="xavier", bias=True,
                 layers: Optional[int] = None) -> Params:
    d_in, d_out = shape_in_out
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    if init == "xavier":
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
            -lim, lim, generator=gen)
    elif init == "normal02":
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * 0.02
    elif init == "zeros":
        w = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        raise ValueError(init)
    p = {"w": w.to(dtype)}
    if bias:
        bshape = (d_out,) if layers is None else (layers, d_out)
        p["b"] = torch.zeros(bshape, dtype=dtype, device=device)
    return p


def init_wan_params(cfg: WanModelConfig, generator: torch.Generator, device=None,
                    dtype=torch.bfloat16) -> Params:
    """Random init with the structure and distributions of the JAX package's
    init_wan_params (causal_model.py:1151-1173), drawn from `generator` and
    made directly on `device`. Only t2v models."""
    if cfg.model_type != "t2v":
        raise NotImplementedError(f"model_type {cfg.model_type!r}: only t2v is ported")
    d, ffn, nl = cfg.dim, cfg.ffn_dim, cfg.num_layers
    pt, ph, pw = cfg.patch_size
    g, dev = generator, device

    def lin(din, dout, **kw):
        return _init_linear(g, (din, dout), dtype, dev, layers=nl, **kw)

    def ones(n):
        return {"scale": torch.ones((nl, n), dtype=dtype, device=dev)}

    def attn_block():
        return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                "norm_q": ones(d), "norm_k": ones(d)}

    blocks = {
        "self_attn": attn_block(),
        "cross_attn": attn_block(),
        "ffn": {"fc1": lin(d, ffn), "fc2": lin(ffn, d)},
        "modulation": torch.randn((nl, 1, 6, d), generator=g, dtype=torch.float32,
                                  device=dev) / d**0.5,
    }
    if cfg.cross_attn_norm:
        blocks["norm3"] = {"scale": torch.ones((nl, d), dtype=dtype, device=dev),
                           "bias": torch.zeros((nl, d), dtype=dtype, device=dev)}
    return {
        "patch_embedding": _init_linear(g, (cfg.in_dim * pt * ph * pw, d), dtype, dev),
        "text_embedding": {
            "fc1": _init_linear(g, (cfg.text_dim, d), dtype, dev, "normal02"),
            "fc2": _init_linear(g, (d, d), dtype, dev, "normal02"),
        },
        "time_embedding": {
            "fc1": _init_linear(g, (cfg.freq_dim, d), torch.float32, dev, "normal02"),
            "fc2": _init_linear(g, (d, d), torch.float32, dev, "normal02"),
        },
        "time_projection": {"fc": _init_linear(g, (d, 6 * d), torch.float32, dev)},
        "blocks": blocks,
        "head": {
            "head": _init_linear(g, (d, math.prod(cfg.patch_size) * cfg.out_dim),
                                 dtype, dev, "zeros"),
            "modulation": torch.randn((1, 2, d), generator=g, dtype=torch.float32,
                                      device=dev) / d**0.5,
        },
    }


def fuse_qkv_params(params: Params) -> Params:
    """Fuse self-attention q/k/v into one [L, D, 3D] projection (reference
    fuse_projections, causal_model.py:203-216); the split weights are dropped."""
    sa = params["blocks"]["self_attn"]
    if "qkv" in sa:
        return params
    fused = {
        "w": torch.cat([sa["q"]["w"], sa["k"]["w"], sa["v"]["w"]], dim=-1),
        "b": torch.cat([sa["q"]["b"], sa["k"]["b"], sa["v"]["b"]], dim=-1),
    }
    new_sa = {k: v for k, v in sa.items() if k not in ("q", "k", "v")}
    new_sa["qkv"] = fused
    return dict(params, blocks=dict(params["blocks"], self_attn=new_sa))


def _layer_views(tree, i: int):
    """The i-th layer of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer_views(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(params: Params, num_layers: int) -> List[Params]:
    return [_layer_views(params["blocks"], i) for i in range(num_layers)]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def patchify(cfg: WanModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, F, C, H, W] latents -> [B, F*h*w, D] tokens (the (1,2,2) Conv3d
    patch embedding as reshape + matmul)."""
    pt, ph, pw = cfg.patch_size
    if pt != 1:
        raise ValueError("temporal patch size must be 1 (Wan uses (1,2,2))")
    b, f, c, H, W = x.shape
    h, w = H // ph, W // pw
    xt = x.reshape(b, f, c, h, ph, w, pw).permute(0, 1, 3, 5, 2, 4, 6)
    tokens = xt.reshape(b, f * h * w, c * ph * pw)
    return linear(params["patch_embedding"], tokens)


def unpatchify(cfg: WanModelConfig, x: torch.Tensor,
               grid: Tuple[int, int, int]) -> torch.Tensor:
    """[B, L, prod(patch)*out] -> [B, F, out, H, W] (causal_model.py:1126-1149)."""
    f, h, w = grid
    pt, ph, pw = cfg.patch_size
    c = cfg.out_dim
    b = x.shape[0]
    y = x.reshape(b, f, h, w, pt, ph, pw, c).permute(0, 1, 4, 7, 2, 5, 3, 6)
    return y.reshape(b, f * pt, c, h * ph, w * pw)


def time_embeddings(cfg: WanModelConfig, params: Params,
                    t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t [B, F] -> (e [B, F, D] f32, e0 [B, F, 6, D] f32)."""
    b, f = t.shape
    sin = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1))
    te = params["time_embedding"]
    e = linear(te["fc2"], F.silu(linear(te["fc1"], sin)))
    e0 = linear(params["time_projection"]["fc"], F.silu(e))
    return e.reshape(b, f, cfg.dim), e0.reshape(b, f, 6, cfg.dim)


def text_embedding(cfg: WanModelConfig, params: Params, context: torch.Tensor) -> torch.Tensor:
    """[B, T, text_dim] -> [B, T, D] (causal_model.py:616-618, 897-902)."""
    te = params["text_embedding"]
    return linear(te["fc2"], gelu_tanh(linear(te["fc1"], context)))


def compute_crossattn_cache(cfg: WanModelConfig, params: Params,
                            context: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-layer text K/V [L, B, T, N, Dh], computed once per prompt."""
    ctx = text_embedding(cfg, params, context)  # [B, T, D]
    ca = params["blocks"]["cross_attn"]
    b, T, _ = ctx.shape
    n, dh, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers

    def project(pp):
        """ctx @ w for every layer, a layer at a time: int8 weights are
        dequantised for this once-per-prompt product, and a whole 14B stack
        in f32 would take 8 GB."""
        def dense_w(i):
            if "w_q" in pp:
                return (pp["w_q"][i].float() * pp["scale"][i]).to(ctx.dtype)
            return pp["w"][i].to(ctx.dtype)
        y = torch.stack([torch.matmul(ctx, dense_w(i)) for i in range(nl)])
        return y + pp["b"].to(ctx.dtype)[:, None, None, :]

    k = rms_norm({"scale": ca["norm_k"]["scale"][:, None, None, :]}, project(ca["k"]))
    v = project(ca["v"])
    return {"k": k.reshape(nl, b, T, n, dh).contiguous(),
            "v": v.reshape(nl, b, T, n, dh).contiguous()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def dit_forward(
    cfg: WanModelConfig,
    params: Params,
    x: torch.Tensor,  # [B, F, C, H, W]
    t: torch.Tensor,  # [B, F] float32 timesteps
    rope_tables: RopeTables,
    crossattn_cache: Dict[str, torch.Tensor],
    mode: str = "decode",
    kv_cache: Optional[Dict] = None,
    current_start: int = 0,
    max_attention_size: Optional[int] = None,
    sink_tokens: int = 0,
    rolling: bool = False,
    prefill_block_tokens: Optional[int] = None,
    layers: Optional[List[Params]] = None,
    act_calib: Optional[list] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One transformer forward. Returns (flow_pred [B, F, C, H, W], kv_cache),
    the cache updated in place (None in train mode). `layers` may carry
    precomputed per-layer views of params["blocks"] (`layer_params`).
    `act_calib`, when given, receives max|input| of every block linear, layer
    by layer in `_calib_site_order`. `attn_mask` ([L, L] bool, True = attend)
    applies in train mode only; without it train mode attends over every
    token, through the unmasked kernel on a card."""
    if mode == "train":
        if kv_cache is not None:
            raise ValueError("train mode takes no kv_cache")
    elif kv_cache is None:
        raise ValueError(f"{mode!r} mode needs a kv_cache")
    elif attn_mask is not None:
        raise ValueError("a dense attn_mask applies in train mode only")
    b, f, c, H, W = x.shape
    pt, ph, pw = cfg.patch_size
    grid = (f, H // ph, W // pw)
    fsl = grid[1] * grid[2]
    L = f * fsl
    n, dh = cfg.num_heads, cfg.head_dim
    current_start = int(current_start)

    tokens = patchify(cfg, params, x)
    e, e0 = time_embeddings(cfg, params, t)

    cache_size = kv_cache["k"].shape[2] if kv_cache is not None else 0
    if mode == "decode":
        if max_attention_size is None:
            raise ValueError("decode mode needs max_attention_size")
        start_frame = current_start // fsl
        shift, write_start, new_global_end, new_local_end = kvc.plan_kv_update(
            kv_cache, current_start, L, cache_size, sink_tokens, rolling)
        win = min(max_attention_size, cache_size)
        win_start = min(max(new_local_end - win, 0), cache_size - win)
        dec_lo = max(new_local_end - max_attention_size, 0) - win_start
        dec_hi = new_local_end - win_start
    elif mode == "prefill":
        if prefill_block_tokens is None:
            raise ValueError("prefill mode needs prefill_block_tokens")
        start_frame, write_start, shift = 0, 0, 0
        new_global_end = new_local_end = L
    elif mode == "train":
        start_frame = 0
    else:
        raise ValueError(f"mode {mode!r}: the port runs 'decode', 'prefill' and 'train'")
    if mode != "train" and (write_start < 0 or write_start + L > cache_size):
        raise ValueError(f"cache write [{write_start}, {write_start + L}) outside "
                         f"the {cache_size}-token cache")

    rope_cos, rope_sin = rope_tables.fused(*grid, start_frame)
    if layers is None:
        layers = layer_params(params, cfg.num_layers)
    lin = linear if act_calib is None else functools.partial(linear, record=act_calib)

    for lid, bp in enumerate(layers):
        em = bp["modulation"][None].float() + e0  # [B, F, 6, D]
        sh_msa, sc_msa, g_msa = em[:, :, 0], em[:, :, 1], em[:, :, 2]
        sh_ffn, sc_ffn, g_ffn = em[:, :, 3], em[:, :, 4], em[:, :, 5]

        # ---- self attention ----
        xn = modulate(layer_norm(tokens, eps=cfg.eps), f, sh_msa, sc_msa)
        sa = bp["self_attn"]
        if "qkv" in sa:
            q, k, v = lin(sa["qkv"], xn).chunk(3, dim=-1)
        else:
            q, k, v = lin(sa["q"], xn), lin(sa["k"], xn), lin(sa["v"], xn)
        q = rms_norm(sa["norm_q"], q, eps=cfg.eps).reshape(b, L, n, dh)
        k = rms_norm(sa["norm_k"], k, eps=cfg.eps).reshape(b, L, n, dh)
        v = v.reshape(b, L, n, dh)
        q = rope_apply_fused(q, rope_cos, rope_sin)
        k = rope_apply_fused(k, rope_cos, rope_sin)

        if mode == "train":
            mask = None if attn_mask is None else attn_mask[None, None]
            y = attn_ops.attention(q, k.contiguous(), v.contiguous(), mask=mask)
        else:
            ck, cv = kv_cache["k"][lid], kv_cache["v"][lid]  # [B, S, N, Dh] views
            if mode == "decode" and rolling and shift:
                ck.copy_(kvc.shift_layer_cache(ck, shift, sink_tokens))
                cv.copy_(kvc.shift_layer_cache(cv, shift, sink_tokens))
            ck[:, write_start:write_start + L] = k.to(ck.dtype)
            cv[:, write_start:write_start + L] = v.to(cv.dtype)
        if mode == "decode":
            wk = ck[:, win_start:win_start + win].to(q.dtype).contiguous()
            wv = cv[:, win_start:win_start + win].to(q.dtype).contiguous()
            y = attn_ops.decode_attention(q, wk, wv, dec_lo, dec_hi)
        elif mode == "prefill":
            y = attn_ops.block_causal_attention(q, k.contiguous(), v.contiguous(),
                                                prefill_block_tokens)
        y = lin(sa["o"], y.reshape(b, L, cfg.dim))
        tokens = tokens + gate(y, f, g_msa)

        # ---- cross attention over the cached text K/V ----
        ca = bp["cross_attn"]
        if cfg.cross_attn_norm:
            xc = layer_norm(tokens, bp["norm3"]["scale"], bp["norm3"]["bias"], eps=cfg.eps)
        else:
            xc = tokens
        qc = rms_norm(ca["norm_q"], lin(ca["q"], xc), eps=cfg.eps).reshape(b, L, n, dh)
        cak = crossattn_cache["k"][lid].to(qc.dtype)
        cav = crossattn_cache["v"][lid].to(qc.dtype)
        yc = attn_ops.attention(qc, cak, cav)
        tokens = tokens + lin(ca["o"], yc.reshape(b, L, cfg.dim))

        # ---- ffn ----
        xf2 = modulate(layer_norm(tokens, eps=cfg.eps), f, sh_ffn, sc_ffn)
        ff = bp["ffn"]
        y = lin(ff["fc2"], gelu_tanh(lin(ff["fc1"], xf2)))
        tokens = tokens + gate(y, f, g_ffn)

    if kv_cache is not None:
        kv_cache["global_end"] = new_global_end
        kv_cache["local_end"] = new_local_end

    # ---- head (CausalHead, causal_model.py:495-523) ----
    hp = params["head"]
    eh = hp["modulation"][None].float() + e[:, :, None, :]  # [B, F, 2, D]
    yh = modulate(layer_norm(tokens, eps=cfg.eps), f, eh[:, :, 0], eh[:, :, 1])
    out = linear(hp["head"], yh)
    return unpatchify(cfg, out, grid), kv_cache


def context_prefill(
    cfg: WanModelConfig,
    params: Params,
    clean_ctx: torch.Tensor,  # [B, F_ctx, C, H, W]
    rope_tables: RopeTables,
    crossattn_cache: Dict[str, torch.Tensor],
    kv_cache: Dict,
    block_tokens: int,
    layers: Optional[List[Params]] = None,
) -> Dict:
    """Write clean-context K/V into a freshly reset cache (the serving
    recompute path, release_server.py:588-633), always through the
    block-causal kernel.

    The JAX package takes a decode-mode forward at current_start=0 when the
    context fits in one block, because that compiled program is faster on the
    TPU. The math is the same: over one block the block-causal mask is dense,
    and both forms write K/V at [0, L) and leave both cache ends at L."""
    b, f = clean_ctx.shape[:2]
    t0 = torch.zeros((b, f), dtype=torch.float32, device=clean_ctx.device)
    _, kv = dit_forward(cfg, params, clean_ctx, t0, rope_tables, crossattn_cache,
                        mode="prefill", kv_cache=kv_cache,
                        prefill_block_tokens=block_tokens, layers=layers)
    return kv
