"""Hand-written Hopper kt x 3 x 3 convolution (K4 with the K5 form), with the
int8 tier's quantise pre-pass and dequantise epilogue: build, bind, launch,
count.

`csrc/conv_sm90.cu` holds one CUDA kernel, a TMA-fed wgmma implicit GEMM
with a warp-specialised mbarrier ring, that replaces two Pallas TPU kernels:
`realtime_video_tpu/ops/pallas_conv2.py::_kernel` (K4, a 3x3 stride-1 conv
over a pre-padded input whose temporal taps the caller concatenated into
channels) and `realtime_video_tpu/ops/pallas_conv.py::_conv_kernel` (K5, kt x
3 x 3 with bias and the temporal taps inside the kernel). K5 is K4's kt > 1
form here: `conv3x3(x, w)` with w [kt, 3, 3, C, Co] reads the kt input frames
of each output frame itself, so the int8 `models/vae.py::conv3d` never
writes the kt*C-wide tap concat; kt = 1 serves the T=1 tap-skip and
`conv2d`. The kernel also pads (zero halos) and strides (the encoder's
stride-2 downsample convs) itself.

Modes: s8 x s8 -> s32 (`conv3x3`, exact for every C), s8 -> the dequantised
bf16 output (`conv3x3_dequant`: bf16(f32(acc) * (a_scale * scale[co]) +
f32(b[co])), the torch sequence of `dequantize_plain`, bit for bit), and bf16
x bf16 -> f32 -> bf16 with an optional bias. `quantize` is the pre-pass that
writes the s8 activation, and `int8_conv` the int8 VAE's whole conv: the
pre-pass and one launch, no torch op between or after.

Layouts. s8 wgmma reads both operands K-major and TMA does not transpose
bytes, so every weight the kernel reads is the [kt, 3, 3, C, Co] view of
[Co, kt, 3, 3, Cp] storage (`k_major`; `quantize_vae_params` and
`vae_params_from_jax` build the int8 VAE's so): every function and test sees
the JAX layout and values. TMA also needs 16-byte global strides, so a
channel count C that is not a multiple of `CHANNEL_ALIGN` (C 3 at the
encoder's input, C 16 at the decoder's) is padded to Cp with zero weight
rows, and the activation's pixels are Cp elements apart: the pre-pass writes
them so, and `pad_channels` does for an activation built by hand.
`check_weight_layout` and `check_input_layout` refuse anything else. A
ragged Co (3, the decoder's head) needs no padding: the kernel's column
tile reads zeros past Co and stores only the real columns.

A CPU tensor goes to the plain versions (`conv3x3_plain`: `F.conv3d` in
float64 for s8, exact for these sums, then int32; float32 for bf16); a CUDA
tensor goes to the kernel or the call raises. `LAUNCHES` counts conv kernel
launches ("conv3x3" every conv, "conv3x3_temporal" those with kt > 1),
`PREPASS_LAUNCHES["conv_quantize"]` those of the quantise pre-pass, and
`PLAIN_ON_CUDA` calls of a plain version on a CUDA tensor (which only a
comparison makes).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from realtime_video_tpu_torch.ops import cuda_build, hopper_int8_mm
from realtime_video_tpu_torch.utils.device import on_card

SOURCE = cuda_build.CSRC / "conv_sm90.cu"

LAUNCHES: Dict[str, int] = {"conv3x3": 0, "conv3x3_temporal": 0}
#: launches of the quantise pre-pass kernel (part of the int8 VAE conv)
PREPASS_LAUNCHES: Dict[str, int] = {"conv_quantize": 0}
#: calls of a plain version (the conv's or the pre-pass's) on a CUDA tensor
PLAIN_ON_CUDA: Dict[str, int] = {"conv3x3": 0}

#: planted faults for the checks that must catch them (kernel argument)
FAULT_ZERO_HALO_ROW = 1  # the input's last row reads as zeros
FAULT_DROP_LAST_C32 = 2  # the last 32 bytes of each pixel's channels read as zeros
FAULT_STALE_RING_STAGE = 3  # the last ring stage holds the previous chunk
FAULT_TAP_ROWS = 4  # tap dx = 2 reads the A rows of tap dx = 1 (stride 1)

#: channel counts the kernel reads unpadded: 32 bytes, one wgmma K step
CHANNEL_ALIGN = {torch.int8: 32, torch.bfloat16: 16}
_BIAS_KIND = {torch.bfloat16: 1, torch.float32: 2}
_OUT_S32, _OUT_DEQUANT, _OUT_BF16 = 0, 1, 2

Padding = Tuple[Tuple[int, int], Tuple[int, int]]

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PREPASS_LAUNCHES, PLAIN_ON_CUDA):
        for key in counts:
            counts[key] = 0


def build() -> Path:
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rtv_conv3x3_sm90.argtypes = ([p] * 5 + [i, p] + [i] * 9 + [ctypes.c_longlong]
                                             + [i] * 8 + [p])
            lib.rtv_conv3x3_sm90.restype = i
            lib.rtv_conv_quantize.argtypes = [p] * 3 + [ctypes.c_longlong, i, i, p]
            lib.rtv_conv_quantize.restype = i
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
# layouts
# ---------------------------------------------------------------------------


def channel_pad(c: int, dtype: torch.dtype) -> int:
    """The channel count Cp >= c that the kernel's layouts pad c to."""
    align = CHANNEL_ALIGN[dtype]
    return -(-c // align) * align


def k_major(w: torch.Tensor) -> torch.Tensor:
    """w [kt, 3, 3, C, Co] with the same values, stored [Co, kt, 3, 3, Cp]
    (C contiguous, channels C..Cp-1 zero) and returned as the [kt, 3, 3, C,
    Co] view: the kernel's weight layout."""
    kt, kh, kw, c, co = w.shape
    store = w.new_zeros((co, kt, kh, kw, channel_pad(c, w.dtype)))
    store[..., :c] = w.permute(4, 0, 1, 2, 3)
    return store[..., :c].permute(1, 2, 3, 4, 0)


def pad_channels(x: torch.Tensor) -> torch.Tensor:
    """x [T, H, W, C] as the view of [T, H, W, Cp] storage (zeros past C),
    the activation layout the kernel reads; x itself when C needs no pad."""
    c = x.shape[-1]
    cp = channel_pad(c, x.dtype)
    if cp == c:
        return x.contiguous()
    store = x.new_zeros(x.shape[:-1] + (cp,))
    store[..., :c] = x
    return store[..., :c]


def _pixel_stride_ok(p: int, c: int, dtype: torch.dtype) -> bool:
    return p >= c and (p * dtype.itemsize) % 16 == 0


def check_weight_layout(w: torch.Tensor) -> None:
    """Raise unless w [kt, 3, 3, C, Co] is a view of [Co, kt', 3, 3, Cp]
    storage (strides (9 Cp, 3 Cp, Cp, 1, >= 9 kt Cp)) with 16-byte strides,
    the only layout the kernel reads (`k_major` builds it)."""
    if w.dim() != 5 or tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"w must be [kt, 3, 3, C, Co], got {tuple(w.shape)}")
    kt, _, _, c, _ = w.shape
    s0, s1, s2, s3, s4 = w.stride()
    p = s2
    if not (s3 == 1 and s1 == 3 * p and s0 == 9 * p and s4 >= 9 * kt * p
            and _pixel_stride_ok(p, c, w.dtype) and (s4 * w.dtype.itemsize) % 16 == 0):
        raise ValueError(f"w must be the [kt, 3, 3, C, Co] view of [Co, kt, 3, 3, Cp] "
                         f"storage with 16-byte strides; got strides {w.stride()} "
                         f"(build it with k_major)")


def check_input_layout(x: torch.Tensor) -> None:
    """Raise unless x [T, H, W, C] has its pixels Cp >= C elements apart,
    Cp * itemsize a multiple of 16 bytes, and rows and frames contiguous."""
    if x.dim() != 4:
        raise ValueError(f"x must be [T, H, W, C], got {tuple(x.shape)}")
    t, h, w_, c = x.shape
    p = x.stride(2)
    want = (h * w_ * p, w_ * p, p, 1)  # a size-1 dim's stride is never used
    if not (all(s == e for s, e, n in zip(x.stride(), want, x.shape) if n > 1)
            and _pixel_stride_ok(p, c, x.dtype)):
        raise ValueError(f"x must have its pixels a multiple of 16 bytes apart and rows "
                         f"contiguous; got shape {tuple(x.shape)} strides {x.stride()} "
                         f"(pad_channels builds it)")


# ---------------------------------------------------------------------------
# plain versions
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


def quantize_plain(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / a), -127, 127) as int8, f32 division and round half to
    even (`hopper_int8_mm.quantize`, the JAX package's `_quantize_act`)."""
    if x.is_cuda:
        PLAIN_ON_CUDA["conv3x3"] += 1
    return hopper_int8_mm.quantize(x, a_scale.float().reshape(()))


def dequantize_plain(yq: torch.Tensor, a_scale: torch.Tensor, scale: torch.Tensor,
                     b: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """float(yq) * (a * scale[co]) + b[co] in f32, cast to dtype: the int8
    VAE conv's dequantise (vae.py:349-364 of the JAX package), which the
    fused epilogue reproduces bit for bit."""
    y = yq.float() * (a_scale.float().reshape(()) * scale.float())
    if b is not None:
        y = y + b.float()
    return y.to(dtype)


def int8_conv_plain(x, w_q, a_scale, scale, b, stride=(1, 1),
                    padding: Padding = ((1, 1), (1, 1))) -> torch.Tensor:
    """The int8 VAE conv in plain PyTorch: quantise, s8 conv, dequantise."""
    yq = conv3x3_plain(quantize_plain(x, a_scale), w_q, stride, padding)
    return dequantize_plain(yq, a_scale, scale, b, x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_device(name: str, t: Optional[torch.Tensor], device) -> None:
    if t is not None and (not t.is_cuda or t.device != device):
        raise ValueError(f"{name} is not on x's CUDA device")


def _check(x, w, bias, stride, padding) -> None:
    if x.dim() != 4 or w.dim() != 5 or w.shape[3] != x.shape[3]:
        raise ValueError(f"x [T, H, W, C] / w [kt, 3, 3, C, Co] expected, got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    if x.dtype not in (torch.int8, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be int8 or both bfloat16, got {x.dtype}/{w.dtype}")
    if bias is not None and (bias.shape != (w.shape[-1],) or bias.dtype not in _BIAS_KIND
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be [Co] bf16 or f32, got {tuple(bias.shape)} {bias.dtype}")
    if any(s not in (1, 2) for s in stride) or any(p < 0 for pair in padding for p in pair):
        raise ValueError(f"stride {stride} / padding {padding} not supported")
    if min(out_shape(x.shape, w.shape, stride, padding)) < 1:
        raise ValueError(f"empty output for x {tuple(x.shape)} w {tuple(w.shape)}")
    check_input_layout(x)
    check_weight_layout(w)
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        _on_device(name, t, x.device)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")


def _check_scale(a_scale, scale, w, x) -> None:
    if a_scale.dtype != torch.float32 or a_scale.numel() != 1:
        raise ValueError(f"a_scale must be one f32, got {tuple(a_scale.shape)} {a_scale.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (w.shape[-1],) \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be [Co] f32, got {tuple(scale.shape)} {scale.dtype}")
    _on_device("a_scale", a_scale, x.device)
    _on_device("scale", scale, x.device)


def _launch(x, w, stride=(1, 1), padding: Padding = ((1, 1), (1, 1)), bias=None,
            fault: int = 0, dequant=None) -> torch.Tensor:
    """One conv launch on checked tensors; `dequant` = (a_scale, scale) asks
    an s8 launch for the dequantised bf16 output (with `bias` as b)."""
    lib = _load()
    int8 = x.dtype == torch.int8
    if not int8:
        mode, dtype = _OUT_BF16, x.dtype
    elif dequant is not None:
        mode, dtype = _OUT_DEQUANT, torch.bfloat16
    else:
        mode, dtype = _OUT_S32, torch.int32
    out = torch.empty(out_shape(x.shape, w.shape, stride, padding), dtype=dtype, device=x.device)
    t, h, w_, c = x.shape
    (ph0, ph1), (pw0, pw1) = padding
    a_scale, scale = dequant if dequant is not None else (None, None)
    with on_card(x):  # the .cu side acts on the current device
        err = lib.rtv_conv3x3_sm90(
            x.data_ptr(), w.data_ptr(), None if a_scale is None else a_scale.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            0 if bias is None else _BIAS_KIND[bias.dtype], out.data_ptr(), int(int8), mode,
            t, h, w_, c, x.stride(2), w.shape[-1], w.stride(2), w.stride(4), w.shape[0],
            stride[0], stride[1], ph0, ph1, pw0, pw1, fault,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rtv_conv3x3_sm90 launch failed: cudaError {err}")
    LAUNCHES["conv3x3"] += 1
    if w.shape[0] > 1:
        LAUNCHES["conv3x3_temporal"] += 1
    return out


def _norm(stride, padding):
    return (tuple(int(s) for s in stride),
            tuple(tuple(int(p) for p in pair) for pair in padding))


def conv3x3(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
            padding: Padding = ((1, 1), (1, 1)),
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [T, H, W, C] (channels last) conv w [kt, 3, 3, C, Co] -> [T - kt + 1,
    Ho, Wo, Co]: int32 sums for int8 operands, bf16 (+ bias) for bf16 ones.
    padding ((h_lo, h_hi), (w_lo, w_hi)) zeros, stride (1|2, 1|2). On a card
    w must be `k_major` and x's pixels 16 bytes apart (`pad_channels`)."""
    stride, padding = _norm(stride, padding)
    if not x.is_cuda:
        return conv3x3_plain(x, w, stride, padding, bias)
    if x.dtype == torch.int8 and bias is not None:
        raise ValueError("the s8 sums take no bias: conv3x3_dequant adds b")
    _check(x, w, bias, stride, padding)
    return _launch(x, w, stride, padding, bias)


def conv3x3_dequant(xq: torch.Tensor, w_q: torch.Tensor, a_scale: torch.Tensor,
                    scale: torch.Tensor, b: Optional[torch.Tensor], stride=(1, 1),
                    padding: Padding = ((1, 1), (1, 1))) -> torch.Tensor:
    """The s8 conv of xq and w_q with the dequantise fused into its epilogue:
    bf16(float(sums) * (a_scale * scale[co]) + b[co]) (`dequantize_plain`).
    a_scale: one f32 in device memory (static, or `dynamic_scale`)."""
    stride, padding = _norm(stride, padding)
    if not xq.is_cuda:
        return dequantize_plain(conv3x3_plain(xq, w_q, stride, padding), a_scale, scale, b,
                                torch.bfloat16)
    if xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8, got {xq.dtype}")
    _check(xq, w_q, b, stride, padding)
    _check_scale(a_scale, scale, w_q, xq)
    return _launch(xq, w_q, stride, padding, b, dequant=(a_scale, scale))


def _quantize_launch(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    lib = _load()
    t, h, w_, c = x.shape
    cp = channel_pad(c, torch.int8)
    xq = torch.empty((t, h, w_, cp), dtype=torch.int8, device=x.device)
    with on_card(x):
        err = lib.rtv_conv_quantize(x.data_ptr(), xq.data_ptr(), a_scale.data_ptr(),
                                    t * h * w_, c, cp,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rtv_conv_quantize launch failed: cudaError {err}")
    PREPASS_LAUNCHES["conv_quantize"] += 1
    return xq[..., :c]


def quantize(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """The per-tensor s8 activation of x [T, H, W, C] (`quantize_plain`'s
    values) as the [T, H, W, C] view of [T, H, W, Cp] storage that the conv
    reads; on a card by the pre-pass kernel."""
    if not x.is_cuda:
        return pad_channels(quantize_plain(x, a_scale))
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x must be [T, H, W, C] bf16 contiguous, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if a_scale.dtype != torch.float32 or a_scale.numel() != 1:
        raise ValueError(f"a_scale must be one f32, got {tuple(a_scale.shape)} {a_scale.dtype}")
    _on_device("a_scale", a_scale, x.device)
    return _quantize_launch(x, a_scale)


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, a_scale: torch.Tensor, scale: torch.Tensor,
              b: Optional[torch.Tensor], stride=(1, 1),
              padding: Padding = ((1, 1), (1, 1))) -> torch.Tensor:
    """The int8 VAE conv of x [T, H, W, C]: quantise per tensor with a_scale,
    the s8 conv of w_q [kt, 3, 3, C, Co], and the dequantise with a_scale *
    scale[co] + b, in x's dtype. On a card: the pre-pass and one conv launch
    with the fused epilogue (bf16 x); on the CPU the same operands, in the
    same layouts, through `conv3x3`'s plain version and `dequantize_plain`."""
    xq = quantize(x, a_scale)
    if not x.is_cuda:
        return dequantize_plain(conv3x3(xq, w_q, stride, padding), a_scale, scale, b, x.dtype)
    return conv3x3_dequant(xq, w_q, a_scale, scale, b, stride, padding)


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
