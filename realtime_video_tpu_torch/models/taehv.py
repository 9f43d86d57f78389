"""TAEHV, the tiny autoencoder for Wan video latents: the server's cheap
preview decode tier (port of realtime_video_tpu/models/taehv.py).

MemBlock (the previous frame's input concatenated on channels), TPool
(`stride` consecutive frames concatenated on channels, frame-major, then a
1x1 conv), TGrow (a 1x1 conv to stride * C channels split into frames),
Clamp (tanh(x / 3) * 3) and nearest spatial upsampling, as in the reference
demo_utils/taehv.py, loaded from taew2_1.pth for Wan 2.1 latents.

As in the JAX package, each MemBlock carries its last input frame in an
explicit state list, so a clip decoded in chunks equals the whole clip.

Layout: activations are [N*T, C, H, W] (channels-last memory on a card, for
cuDNN's tensor-core convs) and conv weights [co, ci, kh, kw], F.conv2d's,
with padding 1 for 3x3 kernels and 0 for 1x1 (JAX's rule). The public API
keeps the JAX layout: latents [N, T, 16, h, w], video [N, T, 3, H, W].
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from realtime_video_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]
State = List[torch.Tensor]

LATENT_CHANNELS = 16
IMAGE_CHANNELS = 3
N_F = (256, 128, 64, 64)


def decoder_plan(time_upscale=(True, True), space_upscale=(True, True, True)) -> List[Tuple]:
    """(kind, args) per layer; kinds: conv, relu, clamp, mem, upsample, tgrow."""
    return [
        ("clamp",), ("conv", LATENT_CHANNELS, N_F[0], True), ("relu",),
        ("mem", N_F[0], N_F[0]), ("mem", N_F[0], N_F[0]), ("mem", N_F[0], N_F[0]),
        ("upsample", 2 if space_upscale[0] else 1),
        ("tgrow", N_F[0], 1), ("conv", N_F[0], N_F[1], False),
        ("mem", N_F[1], N_F[1]), ("mem", N_F[1], N_F[1]), ("mem", N_F[1], N_F[1]),
        ("upsample", 2 if space_upscale[1] else 1),
        ("tgrow", N_F[1], 2 if time_upscale[0] else 1), ("conv", N_F[1], N_F[2], False),
        ("mem", N_F[2], N_F[2]), ("mem", N_F[2], N_F[2]), ("mem", N_F[2], N_F[2]),
        ("upsample", 2 if space_upscale[2] else 1),
        ("tgrow", N_F[2], 2 if time_upscale[1] else 1), ("conv", N_F[2], N_F[3], False),
        ("relu",), ("conv", N_F[3], IMAGE_CHANNELS, True),
    ]


def encoder_plan() -> List[Tuple]:
    """(kind, args) per layer; kinds: conv, conv_s2, relu, mem, tpool."""
    return [
        ("conv", IMAGE_CHANNELS, 64, True), ("relu",),
        ("tpool", 64, 2), ("conv_s2", 64, 64, False),
        ("mem", 64, 64), ("mem", 64, 64), ("mem", 64, 64),
        ("tpool", 64, 2), ("conv_s2", 64, 64, False),
        ("mem", 64, 64), ("mem", 64, 64), ("mem", 64, 64),
        ("tpool", 64, 1), ("conv_s2", 64, 64, False),
        ("mem", 64, 64), ("mem", 64, 64), ("mem", 64, 64),
        ("conv", 64, LATENT_CHANNELS, True),
    ]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_conv(gen, k, cin, cout, bias, dtype, device) -> Params:
    lim = 1.0 / math.sqrt(k * k * cin)
    w = torch.empty((cout, cin, k, k), dtype=torch.float32, device=device)
    p = {"w": w.uniform_(-lim, lim, generator=gen).to(dtype)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=device)
    return p


def init_taehv_params(generator: torch.Generator, device=None, dtype=torch.float32,
                      time_upscale=(True, True)) -> Params:
    """Random init with the JAX init's structure and distributions (uniform
    +-1/sqrt(fan_in), zero biases), drawn from `generator` on `device`
    (default: the CUDA card)."""
    device = resolve_device(device)

    def stage(plan):
        out = []
        for spec in plan:
            kind = spec[0]
            if kind in ("conv", "conv_s2"):
                _, cin, cout, bias = spec
                out.append(_init_conv(generator, 3, cin, cout, bias, dtype, device))
            elif kind == "mem":
                _, cin, cout = spec
                p = {"c0": _init_conv(generator, 3, cin * 2, cout, True, dtype, device),
                     "c1": _init_conv(generator, 3, cout, cout, True, dtype, device),
                     "c2": _init_conv(generator, 3, cout, cout, True, dtype, device)}
                if cin != cout:
                    p["skip"] = _init_conv(generator, 1, cin, cout, False, dtype, device)
                out.append(p)
            elif kind == "tpool":
                _, nf, stride = spec
                out.append(_init_conv(generator, 1, nf * stride, nf, False, dtype, device))
            elif kind == "tgrow":
                _, nf, stride = spec
                out.append(_init_conv(generator, 1, nf, nf * stride, False, dtype, device))
            else:
                out.append(None)
        return out

    return {"encoder": stage(encoder_plan()), "decoder": stage(decoder_plan(time_upscale))}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _conv(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [N*T, Ci, H, W]; w [co, ci, k, k]: padding 1 for k 3, 0 for k 1."""
    w = p["w"]
    b = p.get("b")
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride,
                    padding=1 if w.shape[-1] == 3 else 0)


def _fmt(x: torch.Tensor) -> torch.Tensor:
    """Channels-last memory on a card (reshapes across frames and channels
    hand back NCHW-contiguous tensors); as it is on the CPU."""
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x


def _mem_block(p: Params, x: torch.Tensor, n: int,
               carry: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N*T, C, H, W]; carry [N, 1, C, H, W], the previous call's last input
    frame, or None for a fresh clip (zeros)."""
    xt = x.reshape(n, -1, *x.shape[1:])
    first = torch.zeros_like(xt[:, :1]) if carry is None else carry.to(xt.dtype)
    past = _fmt(torch.cat([first, xt[:, :-1]], dim=1).reshape(x.shape))
    y = F.relu(_conv(p["c0"], torch.cat([x, past], dim=1)))
    y = F.relu(_conv(p["c1"], y))
    y = _conv(p["c2"], y)
    skip = _conv(p["skip"], x) if "skip" in p else x
    # a copy: a view would keep the whole input alive with the state
    return F.relu(y + skip), xt[:, -1:].clone()


def _apply(plan, params, x: torch.Tensor, state: Optional[State]) -> Tuple[torch.Tensor, State]:
    """x [N, T, C, H, W]; state: one carry per MemBlock (None: a fresh clip)."""
    n = x.shape[0]
    xf = _fmt(x.reshape(-1, *x.shape[2:]))
    new_state: State = []
    for spec, p in zip(plan, params):
        kind = spec[0]
        if kind == "conv":
            xf = _conv(p, xf)
        elif kind == "conv_s2":
            xf = _conv(p, xf, stride=2)
        elif kind == "relu":
            xf = F.relu(xf)
        elif kind == "clamp":
            xf = torch.tanh(xf / 3.0) * 3.0
        elif kind == "upsample":
            if spec[1] != 1:
                xf = F.interpolate(xf, scale_factor=spec[1], mode="nearest")
        elif kind == "mem":
            xf, carry = _mem_block(p, xf, n, None if state is None else state[len(new_state)])
            new_state.append(carry)
        elif kind == "tpool":
            # `stride` consecutive frames side by side on channels, frame-major
            stride = spec[2]
            nt, c, h, w = xf.shape
            xf = _conv(p, _fmt(xf.reshape(nt // stride, stride * c, h, w)))
        elif kind == "tgrow":
            # stride * C output channels split into `stride` frames, frame-major
            stride = spec[2]
            xf = _conv(p, xf)
            if stride > 1:
                nt, c, h, w = xf.shape
                xf = _fmt(xf.reshape(nt * stride, c // stride, h, w))
        else:
            raise ValueError(kind)
    return xf.reshape(n, -1, *xf.shape[1:]), new_state


def taehv_decode(params: Params, latents: torch.Tensor, state: Optional[State] = None,
                 time_upscale=(True, True)) -> Tuple[torch.Tensor, State]:
    """Latents [N, T, 16, h, w] (~Gaussian) -> ([N, 4T, 3, 8h, 8w] in ~[0, 1],
    state). A fresh clip's first frames_to_trim() frames are the warm-up
    frames; the caller trims them (the server drops block 0's first 3)."""
    return _apply(decoder_plan(time_upscale), params["decoder"], latents, state)


def taehv_encode(params: Params, video: torch.Tensor,
                 state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """Video [N, T, 3, H, W] in [0, 1], T a multiple of 4 -> (latents
    [N, T/4, 16, H/8, W/8], state)."""
    return _apply(encoder_plan(), params["encoder"], video, state)


def frames_to_trim(time_upscale=(True, True)) -> int:
    return 2 ** sum(time_upscale) - 1


def decode_work(t: int, h: int, w: int, itemsize: int = 2,
                time_upscale=(True, True)) -> Tuple[int, int]:
    """(MACs of the decoder's convolutions, bytes it must move) for T latent
    frames of h x w: the latents, the weights and the carried state read once,
    the pixels and the new state written once, `itemsize` bytes each. The
    elementwise ops are not counted."""
    frames, hh, ww, macs, weights, state = t, h, w, 0, 0, 0
    for spec in decoder_plan(time_upscale):
        kind = spec[0]
        if kind == "conv":
            macs += frames * hh * ww * 9 * spec[1] * spec[2]
            weights += 9 * spec[1] * spec[2] + (spec[2] if spec[3] else 0)
        elif kind == "mem":
            _, cin, cout = spec
            macs += frames * hh * ww * 9 * (2 * cin * cout + 2 * cout * cout)
            weights += 9 * (2 * cin * cout + 2 * cout * cout) + 3 * cout
            if cin != cout:
                macs += frames * hh * ww * cin * cout
                weights += cin * cout
            state += cin * hh * ww
        elif kind == "upsample":
            hh, ww = hh * spec[1], ww * spec[1]
        elif kind == "tgrow":
            macs += frames * hh * ww * spec[1] * spec[1] * spec[2]
            weights += spec[1] * spec[1] * spec[2]
            frames *= spec[2]
    io = t * LATENT_CHANNELS * h * w + weights + 2 * state + frames * IMAGE_CHANNELS * hh * ww
    return macs, io * itemsize


# ---------------------------------------------------------------------------
# checkpoint conversion
# ---------------------------------------------------------------------------


def convert_taehv_checkpoint(sd: Dict[str, torch.Tensor], dtype=torch.float32,
                             device=None) -> Params:
    """A taew2_1.pth state dict (torch Sequential keys) -> the port's tree, on
    `device` (default: where the state dict lies). As the JAX converter
    does, a TGrow conv wider than its plan keeps its last nf * stride output
    channels (taehv.py:195-208 of the reference)."""

    def conv_p(prefix: str, bias: bool = True) -> Params:
        p = {"w": sd[f"{prefix}.weight"].to(device=device, dtype=dtype)}
        if bias and f"{prefix}.bias" in sd:
            p["b"] = sd[f"{prefix}.bias"].to(device=device, dtype=dtype)
        return p

    def stage(plan: Sequence[Tuple], prefix: str) -> list:
        out = []
        for i, spec in enumerate(plan):
            kind, base = spec[0], f"{prefix}.{i}"
            if kind in ("conv", "conv_s2"):
                out.append(conv_p(base))
            elif kind == "mem":
                p = {"c0": conv_p(f"{base}.conv.0"), "c1": conv_p(f"{base}.conv.2"),
                     "c2": conv_p(f"{base}.conv.4")}
                if f"{base}.skip.weight" in sd:
                    p["skip"] = conv_p(f"{base}.skip", bias=False)
                out.append(p)
            elif kind in ("tpool", "tgrow"):
                w = sd[f"{base}.conv.weight"]
                if kind == "tgrow" and w.shape[0] > spec[1] * spec[2]:
                    w = w[-spec[1] * spec[2]:]
                out.append({"w": w.to(device=device, dtype=dtype)})
            else:
                out.append(None)
        return out

    return {"encoder": stage(encoder_plan(), "encoder"),
            "decoder": stage(decoder_plan(), "decoder")}
