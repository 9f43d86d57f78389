"""Hand-written Hopper kt x 3 x 3 convolution (K4 with the K5 form): build,
bind, launch, count.

`csrc/conv3x3.cu` holds one CUDA kernel, an implicit GEMM, that replaces two
Pallas TPU kernels: `realtime_video_tpu/ops/pallas_conv2.py::_kernel` (K4, a
3x3 stride-1 conv over a pre-padded input whose temporal taps the caller
concatenated into channels) and `realtime_video_tpu/ops/pallas_conv.py::
_conv_kernel` (K5, kt x 3 x 3 with bias and the temporal taps inside the
kernel). K5 is K4's kt > 1 form here: `conv3x3(x, w)` with w [kt, 3, 3, C, Co]
reads the kt input frames of each output frame itself, so the int8
`models/vae.py::conv3d` never writes the kt*C-wide tap concat; kt = 1 serves
the T=1 tap-skip and `conv2d`. The kernel also pads (zero halos) and strides
(the encoder's stride-2 downsample convs) itself.

Modes: s8 x s8 -> s32 (the int8 VAE tier; the caller dequantises), exact
for every C; and bf16 x bf16 -> f32 -> bf16 with an optional bias.

A CPU tensor goes to `conv3x3_plain` (`F.conv3d` in float64 for s8, exact for
these sums, then int32; float32 for bf16); a CUDA tensor goes to the kernel or
the call raises. `LAUNCHES` counts kernel launches, `PLAIN_ON_CUDA` calls of
the plain version on a CUDA tensor (which only a comparison makes).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from realtime_video_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "conv3x3.cu"

#: "conv3x3" counts every launch; "conv3x3_temporal" those of them with kt > 1
#: (K5's form: the temporal taps inside the kernel)
LAUNCHES: Dict[str, int] = {"conv3x3": 0, "conv3x3_temporal": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"conv3x3": 0}

#: planted faults for the checks that must catch them (kernel argument)
FAULT_ZERO_HALO_ROW = 1
FAULT_DROP_LAST_CI_CHUNK = 2

_BIAS_KIND = {torch.bfloat16: 1, torch.float32: 2}

Padding = Tuple[Tuple[int, int], Tuple[int, int]]

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLAIN_ON_CUDA):
        for key in counts:
            counts[key] = 0


def build() -> Path:
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.rtv_conv3x3
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_int] * 14 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def out_shape(x_shape: Sequence[int], w_shape: Sequence[int], stride=(1, 1),
              padding: Padding = ((1, 1), (1, 1))) -> Tuple[int, int, int, int]:
    t, h, w_, _ = x_shape
    kt, co = w_shape[0], w_shape[-1]
    (ph0, ph1), (pw0, pw1) = padding
    return (t - kt + 1, (h + ph0 + ph1 - 3) // stride[0] + 1,
            (w_ + pw0 + pw1 - 3) // stride[1] + 1, co)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                  padding: Padding = ((1, 1), (1, 1)),
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function with `F.conv3d`: s8 operands in float64 (exact
    below 2^53), returned as int32; bf16 operands in float32 with TF32 off,
    plus the bias, returned as bf16."""
    if x.is_cuda:
        PLAIN_ON_CUDA["conv3x3"] += 1
    (ph0, ph1), (pw0, pw1) = padding
    ct = torch.float64 if x.dtype == torch.int8 else torch.float32
    xc = F.pad(x.to(ct).permute(3, 0, 1, 2)[None], (pw0, pw1, ph0, ph1))
    wc = w.to(ct).permute(4, 3, 0, 1, 2)  # [Co, C, kt, 3, 3]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv3d(xc, wc, stride=(1, *stride))[0].permute(1, 2, 3, 0)
    if x.dtype == torch.int8:
        return y.to(torch.int32)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _check(x, w, bias, stride, padding) -> None:
    if x.dim() != 4 or w.dim() != 5 or w.shape[1:3] != (3, 3) or w.shape[3] != x.shape[3]:
        raise ValueError(f"x [T, H, W, C] / w [kt, 3, 3, C, Co] expected, got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    if x.dtype not in (torch.int8, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be int8 or both bfloat16, got {x.dtype}/{w.dtype}")
    if x.dtype == torch.int8 and bias is not None:
        raise ValueError("the s8 mode returns int32 sums: the caller adds the bias")
    if bias is not None and (bias.shape != (w.shape[-1],) or bias.dtype not in _BIAS_KIND):
        raise ValueError(f"bias must be [Co] bf16 or f32, got {tuple(bias.shape)} {bias.dtype}")
    if any(s not in (1, 2) for s in stride) or any(p < 0 for pair in padding for p in pair):
        raise ValueError(f"stride {stride} / padding {padding} not supported")
    if min(out_shape(x.shape, w.shape, stride, padding)) < 1:
        raise ValueError(f"empty output for x {tuple(x.shape)} w {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} is not on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and name != "bias":
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(x, w, stride=(1, 1), padding: Padding = ((1, 1), (1, 1)), bias=None,
            fault: int = 0) -> torch.Tensor:
    lib = _load()
    int8 = x.dtype == torch.int8
    out = torch.empty(out_shape(x.shape, w.shape, stride, padding),
                      dtype=torch.int32 if int8 else x.dtype, device=x.device)
    t, h, w_, c = x.shape
    (ph0, ph1), (pw0, pw1) = padding
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rtv_conv3x3(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        0 if bias is None else _BIAS_KIND[bias.dtype], out.data_ptr(), int(int8),
        t, h, w_, c, w.shape[-1], w.shape[0], stride[0], stride[1], ph0, ph1, pw0, pw1,
        fault, stream)
    if err != 0:
        raise RuntimeError(f"rtv_conv3x3 launch failed: cudaError {err}")
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
            padding: Padding = ((1, 1), (1, 1)),
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [T, H, W, C] (channels last) conv w [kt, 3, 3, C, Co] -> [T - kt + 1,
    Ho, Wo, Co]: int32 sums for int8 operands, bf16 (+ bias) for bf16 ones.
    padding ((h_lo, h_hi), (w_lo, w_hi)) zeros, stride (1|2, 1|2)."""
    stride = tuple(int(s) for s in stride)
    padding = tuple(tuple(int(p) for p in pair) for pair in padding)
    if not x.is_cuda:
        return conv3x3_plain(x, w, stride, padding, bias)
    _check(x, w, bias, stride, padding)
    out = _launch(x, w, stride, padding, bias)
    LAUNCHES["conv3x3"] += 1
    if w.shape[0] > 1:
        LAUNCHES["conv3x3_temporal"] += 1
    return out


def conv3x3_ops(x_shape, w_shape, stride=(1, 1),
                padding: Padding = ((1, 1), (1, 1))) -> float:
    """Multiply-add operations (2 per term) of one call."""
    t, ho, wo, co = out_shape(x_shape, w_shape, stride, padding)
    kt, c = w_shape[0], w_shape[3]
    return 2.0 * t * ho * wo * co * kt * 9 * c


def conv3x3_bytes(x_shape, w_shape, stride=(1, 1), padding: Padding = ((1, 1), (1, 1)),
                  in_bytes: int = 1, out_bytes: int = 4, bias: bool = False) -> float:
    """Bytes one call must move: x and w read once, y written once."""
    o = out_shape(x_shape, w_shape, stride, padding)
    n_x = x_shape[0] * x_shape[1] * x_shape[2] * x_shape[3]
    n_w = w_shape[0] * w_shape[1] * w_shape[2] * w_shape[3] * w_shape[4]
    n_y = o[0] * o[1] * o[2] * o[3]
    return (n_x + n_w) * in_bytes + n_y * out_bytes + (4.0 * o[3] if bias else 0.0)
