"""Wan 2.1 causal 3D VAE in PyTorch, `conv` formulation, bf16 and int8 tiers
(port of realtime_video_tpu/models/vae.py).

Same architecture, layout and cache semantics as the JAX package:
  * activations are THWC (time is the conv batch axis, channels last);
  * a kt x 3 x 3 causal conv concatenates its kt temporal taps into channels
    and runs ONE 2D conv (vae.py:315-322); a fresh single-frame chunk skips
    the zero-padded taps and runs only the last one (vae.py:395-409);
  * CausalConv3d splices up to CACHE_T = 2 cached input frames in front of
    the chunk, and each conv's new cache is the last CACHE_T frames
    (vae.py:379-428); caches are a flat tuple in a fixed traversal order;
  * `fuse_decoder_upsample` folds each decoder upsample's nearest 2x and
    3x3 conv into one phase conv at the low resolution (vae.py:724-759),
    which `upsample_conv` recognises by its 2c output channels;
  * the graph runs over a list of row shards of the activations, each on
    its device (`parallel/vae_sp.py` places them), the unsplit VAE as one
    shard: before every conv that reads neighbouring rows each shard takes
    its halo rows from its neighbours (`_Walk.halo`), and at the image's top
    and bottom edges the conv's own zero padding stands in, so one shard
    runs the unsplit convs as they are; the mid-block attention gathers
    every shard's keys and values.

The bf16 tier's 2D convs are `torch.nn.functional.conv2d` on a channels-last
view of the THWC tensor (no copy), as the JAX package leaves them to
`lax.conv`. Weights keep the JAX layout: conv3d [kt, kh, kw, ci, co], conv2d
[kh, kw, ci, co].

The int8 tier (`quantize_vae_params`: the 3x3 convs carry `w_q` [kt, 3, 3,
ci, co] s8, stored K-major, per-output-channel `scale`, and a static
`a_scale` from `calibrate_vae_act_scales` or none for a per-call amax)
quantises each conv's input per tensor (a pre-pass kernel) and runs the kt x
3 x 3 s8 conv in one kernel (`ops/hopper_conv.py`) with the temporal taps,
the zero halos and the stride inside it, and the dequantise in its
epilogue, so neither the tap concat, a padded copy nor the int32 sums are
written. Calibration passes a record dict down the graph
(`calib`), keyed by the id of each float conv's param dict.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from realtime_video_tpu_torch.config import VAE_LATENT_MEAN, VAE_LATENT_STD, VAEConfig
from realtime_video_tpu_torch.ops import hopper_conv, hopper_int8_mm

Params = Dict[str, Any]
Cache = Tuple[torch.Tensor, ...]
#: an activation cut along H into row shards, in row order
Shards = List[torch.Tensor]
#: calibration records: id(param dict) -> max|input| over the calls
Calib = Dict[int, torch.Tensor]

CACHE_T = 2


class _CacheIO:
    """Threads the flat cache tuple through the module graph in its static
    traversal order: `get` reads the next entry, `put` appends an update. It
    also carries the calibration records, if any, down the graph."""

    def __init__(self, entries: Optional[Sequence[torch.Tensor]],
                 calib: Optional[Calib] = None):
        self.entries = list(entries) if entries is not None else None
        self.calib = calib
        self.out: List[torch.Tensor] = []
        self.i = 0

    def get(self) -> Optional[torch.Tensor]:
        v = None if self.entries is None else self.entries[self.i]
        self.i += 1
        return v

    def put(self, v: torch.Tensor) -> None:
        self.out.append(v)


class _Walk:
    """The row shards through the graph: each shard's `_CacheIO` (the
    calibration records shared), the halo rows each shard takes from its
    neighbours, and the int8 convs' dynamic scales. The unsplit VAE is one
    shard: it takes no rows and its convs pad as they always did."""

    def __init__(self, caches: Optional[Sequence[Cache]], n: int,
                 calib: Optional[Calib] = None):
        if caches is not None and len(caches) != n:
            raise ValueError(f"a cache of {len(caches)} shards for {n} shards")
        self.ios = [_CacheIO(c, calib) for c in (caches or [None] * n)]
        self.calib = calib

    def get(self) -> List[Optional[torch.Tensor]]:
        return [io.get() for io in self.ios]

    def put(self, vs: Sequence[torch.Tensor]) -> None:
        for io, v in zip(self.ios, vs):
            io.put(v)

    def caches(self) -> Tuple[Cache, ...]:
        return tuple(tuple(io.out) for io in self.ios)

    def halo(self, xs: Shards, above: int, below: int
             ) -> List[Tuple[torch.Tensor, Tuple[int, int]]]:
        """Each shard [T, h, W, C] with `above` rows of the shard above it
        and `below` of the one below (a peer copy when they lie on other
        devices), and the H padding (top, bottom) its conv adds in their
        place at the image's edges."""
        n, out = len(xs), []
        for s, x in enumerate(xs):
            parts = [x]
            if above and s > 0:
                parts.insert(0, xs[s - 1][:, -above:].to(x.device, non_blocking=True))
            if below and s < n - 1:
                parts.append(xs[s + 1][:, :below].to(x.device, non_blocking=True))
            pad = (above if s == 0 else 0, below if s == n - 1 else 0)
            out.append((torch.cat(parts, dim=1) if len(parts) > 1 else x, pad))
        return out

    def scales(self, ps: Sequence[Params], xs: Shards) -> List[Params]:
        """The conv params of each shard: split, an int8 conv without a
        static activation scale takes the unsplit input's, the largest of the
        shards' per-call scales (a halo'd shard holds rows of the image
        only)."""
        if len(xs) == 1 or "w_q" not in ps[0] or "a_scale" in ps[0]:
            return list(ps)
        own = [hopper_int8_mm.dynamic_scale(x).reshape(()) for x in xs]
        top = torch.stack([a.to(xs[0].device) for a in own]).amax()
        return [dict(p, a_scale=top.to(x.device, non_blocking=True)) for p, x in zip(ps, xs)]


def _sub(ps: Sequence[Params], key) -> List[Params]:
    return [p[key] for p in ps]


def join_rows(xs: Shards, device, dim: int) -> torch.Tensor:
    """The row shards joined along `dim` on `device` (one shard as it is)."""
    if len(xs) == 1:
        return xs[0].to(device, non_blocking=True)
    return torch.cat([x.to(device, non_blocking=True) for x in xs], dim=dim)


# ---------------------------------------------------------------------------
# primitives (THWC)
# ---------------------------------------------------------------------------


def _spatial_conv(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                  padding=((0, 0), (0, 0))) -> torch.Tensor:
    """One 2D conv. x [N, H, W, Ci], w [kh, kw, Ci, Co] -> [N, Ho, Wo, Co].
    padding: ((h_lo, h_hi), (w_lo, w_hi))."""
    (ph0, ph1), (pw0, pw1) = padding
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the channels-last memory
    if ph0 != ph1 and pw0 == pw1 and stride[0] == 1:
        # a row shard at the image's edge: cuDNN pads both sides alike, so
        # pad both by the larger and drop the rows the other side's made
        # (no padded copy of the input)
        p = max(ph0, ph1)
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=(p, pw0))
        return y[:, :, p - ph0:y.shape[2] - (p - ph1)].permute(0, 2, 3, 1)
    if ph0 != ph1 or pw0 != pw1:
        xc = F.pad(xc, (pw0, pw1, ph0, ph1))
        pad = (0, 0)
    else:
        pad = (ph0, pw0)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _record_calib(calib: Optional[Calib], p: Params, x: torch.Tensor) -> None:
    """Keep max|x| of a float conv's input under id(p) (stays on the device)."""
    if calib is not None:
        amax = x.float().abs().amax()
        prev = calib.get(id(p))
        calib[id(p)] = amax if prev is None else torch.maximum(prev, amax)


def _act_scale(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The conv's per-tensor activation scale, f32 0-d: the static `a_scale`,
    or the per-call amax when there is none (computed on x's device)."""
    if "a_scale" in p:
        return p["a_scale"].float()
    return hopper_int8_mm.dynamic_scale(x).reshape(())


def _quantize_act(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8 activation quantisation (the pre-pass on a card).
    Returns (xq int8, a_scale f32 0-d)."""
    a_scale = _act_scale(p, x)
    return hopper_conv.quantize(x, a_scale), a_scale


def _int8_conv2d(p: Params, x: torch.Tensor, stride=(1, 1),
                 padding=((0, 0), (0, 0))) -> torch.Tensor:
    """int8 conv: quantise x [T, H, W, C] per tensor, run the s8 conv of
    w_q [kt, 3, 3, ci, co] with its temporal taps inside the kernel, and
    dequantise the int32 sums with a_scale * scale[co] + b in f32
    (vae.py:325-341 of the JAX package, whose w_q arrives tap-merged). On a
    card: the quantise pre-pass, then one conv launch whose epilogue
    dequantises; no torch op between them or after."""
    # the bf16 convs hand back channels-last views; the pre-pass reads [T, H, W, C]
    x = x.contiguous()
    return hopper_conv.int8_conv(x, p["w_q"], _act_scale(p, x), p["scale"], p["b"], stride,
                                 padding)


def conv3d(p: Params, x: torch.Tensor, stride=(1, 1, 1),
           padding=((0, 0), (0, 0)), calib: Optional[Calib] = None) -> torch.Tensor:
    """3D conv as kt 2D convs: y[t] = sum_i conv2d(x[st*t + i], w[i]); with
    stride 1 the taps are channel-concatenated into one wide conv. On int8
    weights one kernel takes all kt taps."""
    if "w_q" in p:
        if stride[0] != 1:
            raise ValueError("the int8 tier has no strided temporal conv")
        return _int8_conv2d(p, x, stride[1:], padding)
    _record_calib(calib, p, x)
    w = p["w"].to(x.dtype)  # [kt, kh, kw, ci, co]
    kt, kh, kw = w.shape[:3]
    st, sh, sw = stride
    T, H, W, C = x.shape
    t_out = (T - kt) // st + 1
    if kt == 1:
        y = _spatial_conv(x[::st], w[0], (sh, sw), padding)
    elif st == 1:
        xin = torch.cat([x[i:i + t_out] for i in range(kt)], dim=-1)
        w2 = w.permute(1, 2, 0, 3, 4).reshape(kh, kw, kt * C, w.shape[-1])
        y = _spatial_conv(xin, w2, (sh, sw), padding)
    else:  # strided temporal conv (encoder downsample3d): per-tap sum
        y = None
        for i in range(kt):
            xi = x[i:i + st * (t_out - 1) + 1:st]
            yi = _spatial_conv(xi, w[i], (sh, sw), padding)
            y = yi if y is None else y + yi
    return y + p["b"].to(x.dtype)


def conv2d(p: Params, x: torch.Tensor, stride=(1, 1),
           padding=((0, 0), (0, 0)), calib: Optional[Calib] = None) -> torch.Tensor:
    if "w_q" in p:  # [1, kh, kw, ci, co]
        return _int8_conv2d(p, x, stride, padding)
    _record_calib(calib, p, x)
    y = _spatial_conv(x, p["w"].to(x.dtype), stride, padding)
    return y + p["b"].to(x.dtype)


def causal_splice(p: Params, x: torch.Tensor, cache: Optional[torch.Tensor],
                  calib: Optional[Calib] = None):
    """The temporal half of CausalConv3d (vae.py:17-36): (the conv's input,
    the param dict to run it with, the new cache or None). The cache splice
    puts up to CACHE_T cached input frames in front of the chunk; the new
    cache is the last CACHE_T input frames, carrying a cached frame over
    when the chunk is shorter. A fresh single-frame chunk (the anti-drift
    re-encode and the first decode chunk) skips the zero-padded taps: only
    the last tap's 2D conv runs."""
    key = "w_q" if "w_q" in p else "w"
    kt = p[key].shape[0]
    pad_t = 2 * (kt // 2)
    if pad_t == 0:
        return x, p, None
    if cache is None and x.shape[0] == 1:
        _record_calib(calib, p, x)  # under the original param dict
        return (x, dict(p, **{key: p[key][kt - 1:]}),
                torch.cat([torch.zeros_like(x), x], dim=0)[-CACHE_T:])
    if cache is None:
        xin = F.pad(x, (0, 0, 0, 0, 0, 0, pad_t, 0))
        new_cache = x[-CACHE_T:]
        if new_cache.shape[0] < CACHE_T:
            new_cache = torch.cat([torch.zeros_like(new_cache), new_cache],
                                  dim=0)[-CACHE_T:]
    else:
        xin = torch.cat([cache.to(x.dtype), x], dim=0)
        if xin.shape[0] < x.shape[0] + pad_t:
            xin = F.pad(xin, (0, 0, 0, 0, 0, 0, x.shape[0] + pad_t - xin.shape[0], 0))
        new_cache = torch.cat([cache.to(x.dtype), x], dim=0)[-CACHE_T:]
    return xin, p, new_cache


def causal_conv3d(walk: "_Walk", ps: Sequence[Params], xs: Shards) -> Shards:
    """CausalConv3d over row shards: each shard's cache splice and update
    (`causal_splice`), the halo taken on the spliced input, so that the
    neighbours' cached rows come across too and each shard caches its own
    rows only, then the conv with zero padding of half the kernel where no
    neighbour's rows stand in."""
    spliced = [causal_splice(p, x, c, walk.calib) for p, x, c in zip(ps, xs, walk.get())]
    if spliced[0][2] is not None:
        walk.put([c for _, _, c in spliced])
    key = "w_q" if "w_q" in ps[0] else "w"
    kh, kw = ps[0][key].shape[1:3]
    rows = walk.halo([xin for xin, _, _ in spliced], kh // 2, kh // 2)
    runs = walk.scales([p for _, p, _ in spliced], [x for x, _ in rows])
    return [conv3d(p, x, padding=(pad, (kw // 2, kw // 2)), calib=walk.calib)
            for p, (x, pad) in zip(runs, rows)]


def rms_norm_image(p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMS_norm over channels (vae.py:39-54): stats in f32, scaling in the
    input dtype; sqrt(C)/||x|| == rsqrt(mean(x^2))."""
    sq = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(sq + 1e-12).to(x.dtype)
    y = x * inv * p["gamma"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _norm_silu(ps: Sequence[Params], key: str, xs: Shards) -> Shards:
    return [F.silu(rms_norm_image(p[key], x)) for p, x in zip(ps, xs)]


def residual_block(walk: _Walk, ps: Sequence[Params], xs: Shards) -> Shards:
    """ResidualBlock (vae.py:175-209): RMS-SiLU-conv x2 + shortcut."""
    hs = [conv3d(p["shortcut"], x, calib=walk.calib) if "shortcut" in p else x
          for p, x in zip(ps, xs)]
    ys = causal_conv3d(walk, _sub(ps, "conv1"), _norm_silu(ps, "norm1", xs))
    ys = causal_conv3d(walk, _sub(ps, "conv2"), _norm_silu(ps, "norm2", ys))
    return [y + h for y, h in zip(ys, hs)]


def attention_qkv(p: Params, x: torch.Tensor):
    """The mid-block attention's q, k, v [t, h*w, c] of x [t, h, w, c]."""
    t, hh, ww, c = x.shape
    y = rms_norm_image(p["norm"], x).reshape(t, hh * ww, c)
    qkv = torch.matmul(y, p["to_qkv"]["w"].to(y.dtype)) + p["to_qkv"]["b"].to(y.dtype)
    return qkv.chunk(3, dim=-1)


def attention_out(p: Params, x: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """x plus the projected attention of x's queries q over the keys k and
    values v of the whole frame; logits and softmax in f32."""
    t, hh, ww, c = x.shape
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (c ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, v)
    o = torch.matmul(o, p["proj"]["w"].to(o.dtype)) + p["proj"]["b"].to(o.dtype)
    return x + o.reshape(t, hh, ww, c)


def attention_block(ps: Sequence[Params], xs: Shards) -> Shards:
    """Single-head per-frame spatial attention (vae.py:212-251): each row
    shard's queries against the keys and values of the whole frame (every
    shard's, in row order)."""
    qkvs = [attention_qkv(p, x) for p, x in zip(ps, xs)]
    return [attention_out(p, x, q, join_rows([kv[1] for kv in qkvs], x.device, 1),
                          join_rows([kv[2] for kv in qkvs], x.device, 1))
            for p, x, (q, _, _) in zip(ps, xs, qkvs)]


def upsample_time(p: Params, x: torch.Tensor, io: _CacheIO, first: bool) -> torch.Tensor:
    """upsample3d's time conv with its cache (vae.py:100-125): frames double
    (each frame's two halves interleaved over time) except on the first
    chunk, which caches zeros and skips the conv."""
    t, hh, ww, c = x.shape
    if first:
        # first chunk: zero cache, no time conv (vae.py:109-111)
        io.put(torch.zeros((CACHE_T, hh, ww, c), dtype=x.dtype, device=x.device))
        return x
    cache = io.get()
    xin = torch.cat([cache.to(x.dtype), x], dim=0)
    # (3,1,1) valid -> t frames, 2c channels
    y = conv3d(p["time_conv"], xin, calib=io.calib)
    if t >= CACHE_T:
        new_cache = x[-CACHE_T:]
    else:
        last = x[-1:]
        padding = torch.where(cache[-1:] == 0, torch.zeros_like(last),
                              last.to(cache.dtype))
        new_cache = torch.cat([padding.to(x.dtype), last], dim=0)
    io.put(new_cache)
    # interleave the two halves over time (vae.py:123-125)
    return y.reshape(t, hh, ww, 2, c).permute(0, 3, 1, 2, 4).reshape(t * 2, hh, ww, c)


def upsample_conv(conv: Params, x: torch.Tensor, pad=(1, 1),
                  calib: Optional[Calib] = None) -> torch.Tensor:
    """Nearest 2x, then the 3x3 conv dim -> dim // 2 (vae.py:66-99); with a
    phase-folded conv (`fuse_decoder_upsample`), one conv at the original
    resolution that writes the four (dy, dx) output phases, then
    depth-to-space, the same numbers without the 4x upsampled input. A row
    shard's x carries a row of its neighbour above where pad[0] is 0, and
    below where pad[1] is 0: one upsampled row of it is read in place of the
    conv's zero row."""
    t, hh, ww, c = x.shape
    w = conv["w_q"] if "w_q" in conv else conv["w"]
    if w.shape[-1] == 2 * c:  # 4 (c // 2) output channels: folded (vae.py:509-518)
        y = conv2d(conv, x, (1, 1), padding=(pad, (1, 1)), calib=calib)
        h2, co = y.shape[1], y.shape[-1] // 4
        return y.reshape(t, h2, ww, 2, 2, co).permute(0, 1, 3, 2, 4, 5).reshape(
            t, 2 * h2, 2 * ww, co)
    up = x[:, :, None, :, None, :].expand(t, hh, 2, ww, 2, c).reshape(t, 2 * hh, 2 * ww, c)
    up = up[:, 1 - pad[0]:2 * hh - 1 + pad[1]]
    return conv2d(conv, up, (1, 1), padding=(pad, (1, 1)), calib=calib)


def downsample_time(p: Params, x: torch.Tensor, io: _CacheIO, first: bool) -> torch.Tensor:
    """downsample3d's stride-2 time conv with its cache (vae.py:126-149)."""
    if first:
        io.put(x)  # the whole chunk is cached (vae.py:135-137)
        return x
    cache = io.get()
    xin = torch.cat([cache[-1:].to(x.dtype), x], dim=0)
    y = conv3d(p["time_conv"], xin, stride=(2, 1, 1), calib=io.calib)
    io.put(x[-1:])
    return y


def resample(walk: _Walk, ps: Sequence[Params], mode: str, xs: Shards,
             first: bool) -> Shards:
    """Resample up/down 2d/3d with time-conv caches (vae.py:66-149). The
    upsample's halo is one row each way at the low resolution; the
    downsample's ZeroPad2d (0, 1, 0, 1) reads one row from below only."""
    if mode == "upsample3d":
        xs = [upsample_time(p, x, io, first) for p, x, io in zip(ps, xs, walk.ios)]
    if mode in ("upsample2d", "upsample3d"):
        rows = walk.halo(xs, 1, 1)
        convs = walk.scales(_sub(ps, "conv"), [x for x, _ in rows])
        xs = [upsample_conv(c, x, pad, walk.calib) for c, (x, pad) in zip(convs, rows)]
    elif mode in ("downsample2d", "downsample3d"):
        rows = walk.halo(xs, 0, 1)
        convs = walk.scales(_sub(ps, "conv"), [x for x, _ in rows])
        xs = [conv2d(c, x, (2, 2), padding=(pad, (0, 1)), calib=walk.calib)
              for c, (x, pad) in zip(convs, rows)]
    if mode == "downsample3d":
        xs = [downsample_time(p, x, io, first) for p, x, io in zip(ps, xs, walk.ios)]
    return xs


# ---------------------------------------------------------------------------
# encoder / decoder graphs
# ---------------------------------------------------------------------------


def _encoder_plan(cfg: VAEConfig):
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        cur = din
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", cur, dout))
            cur = dout
        if i != len(cfg.dim_mult) - 1:
            mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
            plan.append(("resample", mode, dout))
    return dims, plan


def _decoder_plan(cfg: VAEConfig):
    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        cur = din // 2 if i in (1, 2, 3) else din  # vae.py:380-383
        for _ in range(cfg.num_res_blocks + 1):
            plan.append(("res", cur, dout))
            cur = dout
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if cfg.temperal_upsample[i] else "upsample2d"
            plan.append(("resample", mode, dout))
    return dims, plan


def _stages(walk: _Walk, plan, stage_ps: Sequence[Sequence[Params]], xs: Shards,
            first: bool) -> Shards:
    for i, spec in enumerate(plan):
        pi = [p[i] for p in stage_ps]
        xs = residual_block(walk, pi, xs) if spec[0] == "res" else \
            resample(walk, pi, spec[1], xs, first)
    return xs


def encoder_apply(cfg: VAEConfig, ps: Sequence[Params], xs: Shards,
                  caches: Optional[Sequence[Cache]], first: bool,
                  calib: Optional[Calib] = None) -> Tuple[Shards, Tuple[Cache, ...]]:
    """Encoder3d (vae.py:254-345) over row shards of x [T, H, W, 3] ->
    [T', H/8, W/8, 2z], one cache per shard."""
    walk = _Walk(caches, len(xs), calib)
    xs = causal_conv3d(walk, _sub(ps, "conv1"), xs)
    xs = _stages(walk, _encoder_plan(cfg)[1], _sub(ps, "downsamples"), xs, first)
    xs = residual_block(walk, _sub(ps, "middle_res1"), xs)
    xs = attention_block(_sub(ps, "middle_attn"), xs)
    xs = residual_block(walk, _sub(ps, "middle_res2"), xs)
    xs = causal_conv3d(walk, _sub(ps, "head_conv"), _norm_silu(ps, "head_norm", xs))
    return xs, walk.caches()


def decoder_apply(cfg: VAEConfig, ps: Sequence[Params], xs: Shards,
                  caches: Optional[Sequence[Cache]], first: bool,
                  calib: Optional[Calib] = None) -> Tuple[Shards, Tuple[Cache, ...]]:
    """Decoder3d (vae.py:348-446) over row shards of x [T, h, w, z] ->
    [~4T, 8h, 8w, 3], one cache per shard."""
    walk = _Walk(caches, len(xs), calib)
    xs = causal_conv3d(walk, _sub(ps, "conv1"), xs)
    xs = residual_block(walk, _sub(ps, "middle_res1"), xs)
    xs = attention_block(_sub(ps, "middle_attn"), xs)
    xs = residual_block(walk, _sub(ps, "middle_res2"), xs)
    xs = _stages(walk, _decoder_plan(cfg)[1], _sub(ps, "upsamples"), xs, first)
    xs = causal_conv3d(walk, _sub(ps, "head_conv"), _norm_silu(ps, "head_norm", xs))
    return xs, walk.caches()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _uniform(gen, shape, lim, dtype, device):
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -lim, lim, generator=gen).to(dtype)


def _init_conv3d(gen, kt, kh, kw, cin, cout, dtype, device) -> Params:
    lim = 1.0 / math.sqrt(kt * kh * kw * cin)
    return {"w": _uniform(gen, (kt, kh, kw, cin, cout), lim, dtype, device),
            "b": _uniform(gen, (cout,), lim, dtype, device)}


def _init_conv2d(gen, kh, kw, cin, cout, dtype, device) -> Params:
    lim = 1.0 / math.sqrt(kh * kw * cin)
    return {"w": _uniform(gen, (kh, kw, cin, cout), lim, dtype, device),
            "b": _uniform(gen, (cout,), lim, dtype, device)}


def init_vae_params(cfg: VAEConfig, generator: torch.Generator, device=None,
                    dtype=torch.bfloat16) -> Params:
    """Random init with the structure and distributions of the JAX package's
    init_vae_params, drawn from `generator` directly on `device`."""
    g, dev = generator, device

    def ones(n):
        return {"gamma": torch.ones((n,), dtype=dtype, device=dev)}

    def res(cin, cout):
        p = {"norm1": ones(cin), "conv1": _init_conv3d(g, 3, 3, 3, cin, cout, dtype, dev),
             "norm2": ones(cout), "conv2": _init_conv3d(g, 3, 3, 3, cout, cout, dtype, dev)}
        if cin != cout:
            p["shortcut"] = _init_conv3d(g, 1, 1, 1, cin, cout, dtype, dev)
        return p

    def attn(dim):
        w = torch.randn((dim, dim * 3), generator=g, dtype=torch.float32, device=dev)
        return {"norm": ones(dim),
                "to_qkv": {"w": (w * dim**-0.5).to(dtype),
                           "b": torch.zeros((dim * 3,), dtype=dtype, device=dev)},
                "proj": {"w": torch.zeros((dim, dim), dtype=dtype, device=dev),
                         "b": torch.zeros((dim,), dtype=dtype, device=dev)}}

    def resample_p(mode, dim):
        p = {}
        if mode in ("upsample2d", "upsample3d"):
            p["conv"] = _init_conv2d(g, 3, 3, dim, dim // 2, dtype, dev)
            if mode == "upsample3d":
                p["time_conv"] = _init_conv3d(g, 3, 1, 1, dim, dim * 2, dtype, dev)
        else:
            p["conv"] = _init_conv2d(g, 3, 3, dim, dim, dtype, dev)
            if mode == "downsample3d":
                p["time_conv"] = _init_conv3d(g, 3, 1, 1, dim, dim, dtype, dev)
        return p

    def stage(plan):
        return [res(s[1], s[2]) if s[0] == "res" else resample_p(s[1], s[2]) for s in plan]

    enc_dims, enc_plan = _encoder_plan(cfg)
    dec_dims, dec_plan = _decoder_plan(cfg)
    z = cfg.z_dim
    enc_out, dec_out = enc_dims[-1], dec_dims[-1]
    return {
        "encoder": {
            "conv1": _init_conv3d(g, 3, 3, 3, 3, enc_dims[0], dtype, dev),
            "downsamples": stage(enc_plan),
            "middle_res1": res(enc_out, enc_out),
            "middle_attn": attn(enc_out),
            "middle_res2": res(enc_out, enc_out),
            "head_norm": ones(enc_out),
            "head_conv": _init_conv3d(g, 3, 3, 3, enc_out, z * 2, dtype, dev),
        },
        "decoder": {
            "conv1": _init_conv3d(g, 3, 3, 3, z, dec_dims[0], dtype, dev),
            "middle_res1": res(dec_dims[0], dec_dims[0]),
            "middle_attn": attn(dec_dims[0]),
            "middle_res2": res(dec_dims[0], dec_dims[0]),
            "upsamples": stage(dec_plan),
            "head_norm": ones(dec_out),
            "head_conv": _init_conv3d(g, 3, 3, 3, dec_out, 3, dtype, dev),
        },
        "conv1": _init_conv3d(g, 1, 1, 1, z * 2, z * 2, dtype, dev),  # vae.py:479
        "conv2": _init_conv3d(g, 1, 1, 1, z, z, dtype, dev),  # vae.py:480
    }


#: (z_dim, device) -> the latent (mean, std) built there
_LATENT_SCALES: Dict[Tuple[int, Any], Tuple[torch.Tensor, torch.Tensor]] = {}


def latent_scale(cfg: VAEConfig, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel latent (mean, std), f32; zeros/ones for tiny test configs.
    Built once per (z_dim, device) and kept: the host-to-card copy of the
    lists waits for the card's queue, and every encode and decode reads
    them. Callers must not write to them."""
    key = (cfg.z_dim, None if device is None else torch.device(device))
    if key not in _LATENT_SCALES:
        if cfg.z_dim == len(VAE_LATENT_MEAN):
            mean = torch.tensor(VAE_LATENT_MEAN, dtype=torch.float32, device=device)
            std = torch.tensor(VAE_LATENT_STD, dtype=torch.float32, device=device)
        else:
            mean = torch.zeros((cfg.z_dim,), dtype=torch.float32, device=device)
            std = torch.ones((cfg.z_dim,), dtype=torch.float32, device=device)
        _LATENT_SCALES[key] = (mean, std)
    return _LATENT_SCALES[key]


# ---------------------------------------------------------------------------
# chunked entry points (the public VAE API)
# ---------------------------------------------------------------------------


def encode_rows(cfg: VAEConfig, ps: Sequence[Params], videos: Shards,
                caches: Optional[Sequence[Cache]] = None, stream: bool = False,
                calib: Optional[Calib] = None) -> Tuple[Shards, Tuple[Cache, ...]]:
    """Chunked encode of row shards of video [1, T, H, W, 3], shard s with
    params ps[s] on its device: chunks 1,4,4,... fresh (vae.py:491-517) or
    4,4,... streaming. Returns the shards of the normalised latents [1, Tz,
    h, w, z] and one cache per shard."""
    if videos[0].shape[0] != 1:
        raise ValueError("streaming VAE paths are single-stream (B=1)")
    if len(videos) > 1 and any(v.shape[2] % 8 for v in videos):
        raise ValueError(f"row shards of heights {[v.shape[2] for v in videos]}: each must "
                         f"divide by 8, the encoder's three stride-2 downsamples")
    vids = [v[0] for v in videos]
    t = vids[0].shape[0]
    enc = _sub(ps, "encoder")
    outs = []
    if not stream:
        if caches is not None:
            raise ValueError("pass stream=True to continue a warm encode")
        zs, caches = encoder_apply(cfg, enc, [v[:1] for v in vids], None, True, calib)
        outs.append(zs)
        rest = range(1, t, 4)
    else:
        if caches is None:
            raise ValueError("streaming encode needs a warm cache")
        rest = range(0, t, 4)
    for s in rest:
        zs, caches = encoder_apply(cfg, enc, [v[s:s + 4] for v in vids], caches, False, calib)
        outs.append(zs)
    mus = []
    for p, zs, v in zip(ps, zip(*outs), videos):
        mu, _log_var = conv3d(p["conv1"], torch.cat(zs, dim=0), calib=calib).chunk(2, dim=-1)
        mean, std = latent_scale(cfg, v.device)
        mus.append(((mu.float() - mean) / std).to(v.dtype)[None])
    return mus, caches


def decode_rows(cfg: VAEConfig, ps: Sequence[Params], latents: Shards,
                caches: Optional[Sequence[Cache]] = None, first: Optional[bool] = None,
                chunk: int = 1, calib: Optional[Calib] = None
                ) -> Tuple[Shards, Tuple[Cache, ...]]:
    """Streaming decode of row shards of normalised latents [1, Tz, h, w, z]
    (vae.py:519-567), shard s with params ps[s] on its device.

    The first chunk of a stream (caches None) skips temporal upsampling for
    frame 0: 1 + 4*(Tz-1) output frames; later calls give 4*Tz. Returns the
    shards of the pixels, f32 in [-1, 1], [1, T, H, W, 3], and one cache per
    shard."""
    if first is None:
        first = caches is None
    if latents[0].shape[0] != 1:
        raise ValueError("streaming VAE paths are single-stream (B=1)")
    xs = []
    for p, z in zip(ps, latents):
        mean, std = latent_scale(cfg, z.device)
        xs.append(conv3d(p["conv2"], (z[0].float() * std + mean).to(z.dtype), calib=calib))
    dec = _sub(ps, "decoder")
    outs = []
    start, tz = 0, xs[0].shape[0]
    if first:
        ys, caches = decoder_apply(cfg, dec, [x[:1] for x in xs], caches, True, calib)
        outs.append(ys)
        start = 1
    while start < tz:
        stop = min(start + chunk, tz)
        ys, caches = decoder_apply(cfg, dec, [x[start:stop] for x in xs], caches, False, calib)
        outs.append(ys)
        start = stop
    return [torch.clamp(join_rows(list(ys), ys[0].device, 0).float(), -1.0, 1.0)[None]
            for ys in zip(*outs)], caches


def encode_chunks(cfg: VAEConfig, params: Params, video: torch.Tensor,
                  cache: Optional[Cache] = None, stream: bool = False,
                  calib: Optional[Calib] = None) -> Tuple[torch.Tensor, Cache]:
    """`encode_rows` of the whole video [1, T, H, W, 3] as one shard:
    normalised latents [1, Tz, h, w, z] and the cache."""
    zs, caches = encode_rows(cfg, [params], [video], None if cache is None else [cache],
                             stream, calib)
    return zs[0], caches[0]


def decode_chunks(cfg: VAEConfig, params: Params, latents: torch.Tensor,
                  cache: Optional[Cache] = None, first: Optional[bool] = None,
                  chunk: int = 1, calib: Optional[Calib] = None) -> Tuple[torch.Tensor, Cache]:
    """`decode_rows` of the whole latents [1, Tz, h, w, z] as one shard:
    pixels [1, T, H, W, 3] and the cache."""
    pxs, caches = decode_rows(cfg, [params], [latents], None if cache is None else [cache],
                              first, chunk, calib)
    return pxs[0], caches[0]


def fuse_decoder_upsample(params: Params) -> Params:
    """Fold each decoder upsample's nearest 2x + 3x3 conv into one conv at
    the original resolution that writes the four (dy, dx) output phases
    (vae.py:724-759 of the JAX package; `upsample_conv` de-interleaves them).
    An exact rewrite: phase (dy, dx) reads a 2x2 original-pixel support, its
    kernel the rows and columns of w folded with T0 = [[1,0,0],[0,1,1],[0,0,0]]
    (even outputs) or T1 = [[0,0,0],[1,1,0],[0,0,1]] (odd), zero-padded back
    to 3x3: w [3, 3, ci, co] -> [3, 3, ci, 4 co] (phases 2 dy + dx), the bias
    tiled 4 times. Float convs only, so run it before `quantize_vae_params`;
    an int8 tree passes through untouched."""

    def fuse_conv(conv: Params) -> Params:
        w = conv["w"]
        # in f32, rounded once to w's dtype: each folded tap sums <= 4 taps
        t0 = torch.tensor([[1, 0, 0], [0, 1, 1], [0, 0, 0]], dtype=torch.float32,
                          device=w.device)
        t1 = torch.tensor([[0, 0, 0], [1, 1, 0], [0, 0, 1]], dtype=torch.float32,
                          device=w.device)
        phases = [torch.einsum("ak,bl,klio->abio", ty, tx, w.float())
                  for ty in (t0, t1) for tx in (t0, t1)]
        return {"w": torch.cat(phases, dim=-1).to(w.dtype), "b": conv["b"].repeat(4)}

    out = dict(params)
    dec = dict(out["decoder"])
    ups = []
    for p in dec["upsamples"]:
        if isinstance(p, dict) and "conv" in p and "w" in p["conv"] \
                and p["conv"]["w"].dim() == 4 and p["conv"]["w"].shape[0] == 3:
            p = dict(p, conv=fuse_conv(p["conv"]))
        ups.append(p)
    dec["upsamples"] = ups
    out["decoder"] = dec
    return out


# ---------------------------------------------------------------------------
# int8 tier: calibration and quantisation
# ---------------------------------------------------------------------------


def calibrate_vae_act_scales(cfg: VAEConfig, params: Params, latents: torch.Tensor,
                             pixels: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Per-conv max|input| over a float streaming decode of latents [1, Tz, h,
    w, z] (first chunk, then one latent at a time) and, with pixels [1, T, H,
    W, 3], a fresh encode: {tree path: amax} for quantize_vae_params
    (vae.py:762-791 of the JAX package). Path keys survive copies of the
    tree between calibration and quantisation."""
    calib: Calib = {}
    _, cache = decode_chunks(cfg, params, latents[:, :1], None, first=True, calib=calib)
    for i in range(1, latents.shape[1]):
        _, cache = decode_chunks(cfg, params, latents[:, i:i + 1], cache, first=False,
                                 calib=calib)
    if pixels is not None:
        encode_chunks(cfg, params, pixels, None, stream=False, calib=calib)
    return {path: float(calib[id(node)]) for path, node in _walk_paths(params)
            if id(node) in calib}


def _walk_paths(node, path=""):
    """Yield (path, node) for every dict node of a VAE param tree."""
    if isinstance(node, dict):
        yield path, node
        for k, v in node.items():
            yield from _walk_paths(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _walk_paths(v, f"{path}/{i}")


def quantize_vae_params(params: Params, act_scales: Optional[Dict[str, float]] = None,
                        margin: float = 1.5) -> Params:
    """int8-quantise the 3x3 spatial convs of a VAE param tree in torch on the
    parameters' device (vae.py:805-874 of the JAX package): w_q [kt, 3, 3, ci,
    co] (conv2d weights gain a leading kt = 1) with per-output-channel scales,
    encoder and decoder both. w_q is the view of [co, kt, 3, 3, cp] storage
    (`hopper_conv.k_major`: ci padded with zero rows to the kernel's channel
    alignment), the conv kernel's K-major layout. 1x1 convs, time convs, attention and norms stay
    as they are. Convs found in `act_scales` get a static activation scale
    amax * margin / 127."""
    attached = [0]

    def quant(p, path):
        w = p["w"].float()
        if w.dim() == 5:  # conv3d [kt, kh, kw, ci, co]
            if w.shape[1] != 3:  # 1x1 spatial and time convs stay float
                return p
            wq5 = w
        elif w.dim() == 4:  # conv2d [kh, kw, ci, co]
            if w.shape[0] != 3:
                return p
            wq5 = w[None]
        else:
            return p
        co = wq5.shape[-1]
        amax = torch.clamp(wq5.abs().reshape(-1, co).amax(dim=0), min=1e-8)
        # a tensor divisor: on a card PyTorch divides by a Python scalar as a
        # multiply by its reciprocal, not the IEEE quotient numpy gives
        scale = amax / torch.full_like(amax, 127.0)
        wq = torch.clamp(torch.round(wq5 / scale), -127, 127).to(torch.int8)
        out = {"w_q": hopper_conv.k_major(wq), "scale": scale, "b": p["b"]}
        if act_scales and path in act_scales:
            # Python floats (float64) on the host, as the JAX package's scale
            out["a_scale"] = torch.tensor(max(float(act_scales[path]), 1e-6) * margin / 127.0,
                                          dtype=torch.float32, device=w.device)
            attached[0] += 1
        return out

    def walk(node, path=""):
        if isinstance(node, dict):
            if "w" in node and "b" in node and torch.is_tensor(node["w"]):
                return quant(node, path)
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return node

    out = walk(params)
    if act_scales and not attached[0]:
        raise ValueError("act_scales attached to no conv: its paths do not match this "
                         "param tree")
    return out
