"""Wan 2.1 causal 3D VAE in PyTorch, `conv` formulation, bf16 and int8 tiers
(port of realtime_video_tpu/models/vae.py).

Same architecture, layout and cache semantics as the JAX package:
  * activations are THWC (time is the conv batch axis, channels last);
  * a kt x 3 x 3 causal conv concatenates its kt temporal taps into channels
    and runs ONE 2D conv (vae.py:315-322); a fresh single-frame chunk skips
    the zero-padded taps and runs only the last one (vae.py:395-409);
  * CausalConv3d splices up to CACHE_T = 2 cached input frames in front of
    the chunk, and each conv's new cache is the last CACHE_T frames
    (vae.py:379-428); caches are a flat tuple in a fixed traversal order.

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


# ---------------------------------------------------------------------------
# primitives (THWC)
# ---------------------------------------------------------------------------


def _spatial_conv(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                  padding=((0, 0), (0, 0))) -> torch.Tensor:
    """One 2D conv. x [N, H, W, Ci], w [kh, kw, Ci, Co] -> [N, Ho, Wo, Co].
    padding: ((h_lo, h_hi), (w_lo, w_hi))."""
    (ph0, ph1), (pw0, pw1) = padding
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the channels-last memory
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


def causal_conv3d(p: Params, x: torch.Tensor, cache: Optional[torch.Tensor],
                  io: _CacheIO, stride=(1, 1, 1)) -> torch.Tensor:
    """CausalConv3d with the cache splice (vae.py:17-36) and cache update
    (the last CACHE_T input frames, carrying a cached frame over when the
    chunk is shorter)."""
    key = "w_q" if "w_q" in p else "w"
    kt, kh, kw = p[key].shape[:3]
    pad_t, pad_h, pad_w = 2 * (kt // 2), kh // 2, kw // 2
    spad = ((pad_h, pad_h), (pad_w, pad_w))
    if pad_t > 0:
        if cache is None and x.shape[0] == 1:
            # fresh single-frame chunk (the anti-drift re-encode and the first
            # decode chunk): the zero-padded taps contribute nothing, so only
            # the last tap's 2D conv runs
            _record_calib(io.calib, p, x)  # under the original param dict
            io.put(torch.cat([torch.zeros_like(x), x], dim=0)[-CACHE_T:])
            return conv3d(dict(p, **{key: p[key][kt - 1:]}), x, stride=stride,
                          padding=spad, calib=io.calib)
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
        io.put(new_cache)
    else:
        xin = x
    return conv3d(p, xin, stride=stride, padding=spad, calib=io.calib)


def rms_norm_image(p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMS_norm over channels (vae.py:39-54): stats in f32, scaling in the
    input dtype; sqrt(C)/||x|| == rsqrt(mean(x^2))."""
    sq = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(sq + 1e-12).to(x.dtype)
    y = x * inv * p["gamma"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def residual_block(p: Params, x: torch.Tensor, io: _CacheIO) -> torch.Tensor:
    """ResidualBlock (vae.py:175-209): RMS-SiLU-conv x2 + shortcut."""
    h = x
    if "shortcut" in p:
        h = conv3d(p["shortcut"], x, calib=io.calib)
    y = F.silu(rms_norm_image(p["norm1"], x))
    y = causal_conv3d(p["conv1"], y, io.get(), io)
    y = F.silu(rms_norm_image(p["norm2"], y))
    y = causal_conv3d(p["conv2"], y, io.get(), io)
    return y + h


def attention_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Single-head per-frame spatial attention (vae.py:212-251); logits and
    softmax in f32."""
    t, hh, ww, c = x.shape
    y = rms_norm_image(p["norm"], x).reshape(t, hh * ww, c)
    qkv = torch.matmul(y, p["to_qkv"]["w"].to(y.dtype)) + p["to_qkv"]["b"].to(y.dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (c ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, v)
    o = torch.matmul(o, p["proj"]["w"].to(o.dtype)) + p["proj"]["b"].to(o.dtype)
    return x + o.reshape(t, hh, ww, c)


def resample(p: Params, mode: str, x: torch.Tensor, io: _CacheIO,
             first: bool) -> torch.Tensor:
    """Resample up/down 2d/3d with time-conv caches (vae.py:66-149)."""
    t, hh, ww, c = x.shape
    if mode == "upsample3d":
        if first:
            # first chunk: zero cache, no time conv (vae.py:109-111)
            io.put(torch.zeros((CACHE_T, hh, ww, c), dtype=x.dtype, device=x.device))
        else:
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
            x = y.reshape(t, hh, ww, 2, c).permute(0, 3, 1, 2, 4).reshape(t * 2, hh, ww, c)
            t = x.shape[0]

    if mode in ("upsample2d", "upsample3d"):
        # nearest 2x, then a 3x3 conv dim -> dim // 2
        up = x[:, :, None, :, None, :].expand(t, hh, 2, ww, 2, c).reshape(
            t, 2 * hh, 2 * ww, c)
        x = conv2d(p["conv"], up, (1, 1), padding=((1, 1), (1, 1)), calib=io.calib)
    elif mode in ("downsample2d", "downsample3d"):
        # ZeroPad2d (0,1,0,1) + 3x3 stride-2 conv (vae.py:90-98)
        x = conv2d(p["conv"], x, (2, 2), padding=((0, 1), (0, 1)), calib=io.calib)

    if mode == "downsample3d":
        if first:
            io.put(x)  # the whole chunk is cached (vae.py:135-137)
        else:
            cache = io.get()
            pre = x
            xin = torch.cat([cache[-1:].to(x.dtype), x], dim=0)
            x = conv3d(p["time_conv"], xin, stride=(2, 1, 1), calib=io.calib)
            io.put(pre[-1:])
    return x


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


def encoder_apply(cfg: VAEConfig, params: Params, x: torch.Tensor,
                  cache: Optional[Cache], first: bool,
                  calib: Optional[Calib] = None) -> Tuple[torch.Tensor, Cache]:
    """Encoder3d (vae.py:254-345). x [T, H, W, 3] -> [T', H/8, W/8, 2z]."""
    io = _CacheIO(cache, calib)
    x = causal_conv3d(params["conv1"], x, io.get(), io)
    _, plan = _encoder_plan(cfg)
    for spec, p in zip(plan, params["downsamples"]):
        if spec[0] == "res":
            x = residual_block(p, x, io)
        else:
            x = resample(p, spec[1], x, io, first)
    x = residual_block(params["middle_res1"], x, io)
    x = attention_block(params["middle_attn"], x)
    x = residual_block(params["middle_res2"], x, io)
    x = F.silu(rms_norm_image(params["head_norm"], x))
    x = causal_conv3d(params["head_conv"], x, io.get(), io)
    return x, tuple(io.out)


def decoder_apply(cfg: VAEConfig, params: Params, x: torch.Tensor,
                  cache: Optional[Cache], first: bool,
                  calib: Optional[Calib] = None) -> Tuple[torch.Tensor, Cache]:
    """Decoder3d (vae.py:348-446). x [T, h, w, z] -> [~4T, 8h, 8w, 3]."""
    io = _CacheIO(cache, calib)
    x = causal_conv3d(params["conv1"], x, io.get(), io)
    x = residual_block(params["middle_res1"], x, io)
    x = attention_block(params["middle_attn"], x)
    x = residual_block(params["middle_res2"], x, io)
    _, plan = _decoder_plan(cfg)
    for spec, p in zip(plan, params["upsamples"]):
        if spec[0] == "res":
            x = residual_block(p, x, io)
        else:
            x = resample(p, spec[1], x, io, first)
    x = F.silu(rms_norm_image(params["head_norm"], x))
    x = causal_conv3d(params["head_conv"], x, io.get(), io)
    return x, tuple(io.out)


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


def latent_scale(cfg: VAEConfig, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel latent (mean, std), f32; zeros/ones for tiny test configs."""
    if cfg.z_dim == len(VAE_LATENT_MEAN):
        mean = torch.tensor(VAE_LATENT_MEAN, dtype=torch.float32, device=device)
        std = torch.tensor(VAE_LATENT_STD, dtype=torch.float32, device=device)
    else:
        mean = torch.zeros((cfg.z_dim,), dtype=torch.float32, device=device)
        std = torch.ones((cfg.z_dim,), dtype=torch.float32, device=device)
    return mean, std


# ---------------------------------------------------------------------------
# chunked entry points (the public VAE API)
# ---------------------------------------------------------------------------


def encode_chunks(cfg: VAEConfig, params: Params, video: torch.Tensor,
                  cache: Optional[Cache] = None, stream: bool = False,
                  calib: Optional[Calib] = None) -> Tuple[torch.Tensor, Cache]:
    """Chunked encode of video [1, T, H, W, 3]: chunks 1,4,4,... fresh
    (vae.py:491-517) or 4,4,... streaming. Returns normalised latents
    [1, Tz, h, w, z] and the cache."""
    if video.shape[0] != 1:
        raise ValueError("streaming VAE paths are single-stream (B=1)")
    vid = video[0]
    t = vid.shape[0]
    outs = []
    if not stream:
        if cache is not None:
            raise ValueError("pass stream=True to continue a warm encode")
        z, cache = encoder_apply(cfg, params["encoder"], vid[:1], None, first=True,
                                 calib=calib)
        outs.append(z)
        rest = range(1, t, 4)
    else:
        if cache is None:
            raise ValueError("streaming encode needs a warm cache")
        rest = range(0, t, 4)
    for s in rest:
        z, cache = encoder_apply(cfg, params["encoder"], vid[s:s + 4], cache, first=False,
                                 calib=calib)
        outs.append(z)
    out = torch.cat(outs, dim=0)
    mu, _log_var = conv3d(params["conv1"], out, calib=calib).chunk(2, dim=-1)
    mean, std = latent_scale(cfg, video.device)
    mu = (mu.float() - mean) / std
    return mu.to(video.dtype)[None], cache


def decode_chunks(cfg: VAEConfig, params: Params, latents: torch.Tensor,
                  cache: Optional[Cache] = None, first: Optional[bool] = None,
                  chunk: int = 1, calib: Optional[Calib] = None) -> Tuple[torch.Tensor, Cache]:
    """Streaming decode of normalised latents [1, Tz, h, w, z] (vae.py:519-567).

    The first chunk of a stream (cache None) skips temporal upsampling for
    frame 0: 1 + 4*(Tz-1) output frames; later calls give 4*Tz. Pixels come
    back as f32 in [-1, 1], [1, T, H, W, 3]."""
    if first is None:
        first = cache is None
    if latents.shape[0] != 1:
        raise ValueError("streaming VAE paths are single-stream (B=1)")
    mean, std = latent_scale(cfg, latents.device)
    z = (latents[0].float() * std + mean).to(latents.dtype)
    x = conv3d(params["conv2"], z, calib=calib)
    outs = []
    start = 0
    if first:
        y, cache = decoder_apply(cfg, params["decoder"], x[:1], cache, first=True,
                                 calib=calib)
        outs.append(y)
        start = 1
    while start < x.shape[0]:
        stop = min(start + chunk, x.shape[0])
        y, cache = decoder_apply(cfg, params["decoder"], x[start:stop], cache, first=False,
                                 calib=calib)
        outs.append(y)
        start = stop
    out = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    return torch.clamp(out.float(), -1.0, 1.0)[None], cache


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
