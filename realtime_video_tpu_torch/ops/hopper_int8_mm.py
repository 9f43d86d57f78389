"""Hand-written Hopper fused int8 linear (K3): build, bind, launch, count.

`csrc/int8_mm.cu` holds one CUDA kernel (wgmma s8, TMA, a warp-specialised
pipeline, after a pre-pass that writes the s8 quanta of x) that replaces both
Pallas TPU kernels of `realtime_video_tpu/ops/pallas_int8_mm.py`:
`_mm_kernel_kres` (K3a, K <= 2048, x quantised once per m tile into VMEM) and
`_mm_kernel` (K3b, K tiled with an s32 VMEM accumulator). The K-resident
split exists only because of the TPU's VMEM size; a K loop with an s32
register accumulator is both forms.

    y = bf16( float(q(x) @ w_q) * (a_scale * w_scale[n]) + b[n] ),
    q(x) = clip(round_half_even(x / a_scale), -127, 127) as s8

which is `models/wan_dit.py::linear` on int8 weights. `a_scale` is a one-
element f32 tensor: a static per-layer scale (a slice of the [L] tensor the
quantiser stores) or the amax of x computed on the device (`dynamic_scale`);
the kernel reads it through its pointer, so no call waits for the device.

Weight layout: s8 wgmma reads both operands K-contiguous from shared memory
and TMA cannot transpose bytes, so w_q is stored [N, K] (K contiguous) and
handed out as its [K, N] view (`k_major`; strides (1, K)): every public
function, the plain version and `utils/convert.py` see the JAX layout and
values, and no weight is stored twice. `quantize_wan_linears` and
`wan_params_from_jax` build that storage. The kernel wrapper accepts exactly
strides (1, K) (`check_weight_layout`) and copies nothing.

A CPU tensor goes to `int8_linear_plain`, the same arithmetic in plain
PyTorch (an int64 product); a CUDA tensor goes to the kernel or the call
raises. `LAUNCHES` counts kernel launches, `PLAIN_ON_CUDA` calls of the plain
version on a CUDA tensor (which only a comparison with the kernel makes; it
uses a float64 product there, exact for these sums).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from realtime_video_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "int8_mm.cu"

#: "int8_linear" counts every launch; "int8_linear_k_tiled" those of them
#: with K > K_RESIDENT_MAX, which the TPU sends to K3b (`_mm_kernel`) and not
#: K3a (`_mm_kernel_kres`), so the two forms' shares of a run can be read
LAUNCHES: Dict[str, int] = {"int8_linear": 0, "int8_linear_k_tiled": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"int8_linear": 0}
#: pallas_int8_mm.int8_linear keeps K resident (K3a) up to this K
K_RESIDENT_MAX = 2048

#: planted faults for the checks that must catch them (kernel argument)
FAULT_DROP_LAST_K_TILE = 1
FAULT_W_SCALE_SHIFT = 2
FAULT_STALE_RING_STAGE = 3  # the last ring stage holds the previous K tile

_BIAS_KIND = {torch.bfloat16: 1, torch.float32: 2}

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
            fn = lib.rtv_int8_linear
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def k_major(w: torch.Tensor) -> torch.Tensor:
    """w [..., K, N] with the same values, stored [..., N, K] (K contiguous)
    and returned as the [..., K, N] view: the kernel's weight layout."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def check_weight_layout(w_q: torch.Tensor) -> None:
    """Raise unless w_q [K, N] is the view of [N, K] contiguous storage
    (strides (1, K)), the only layout the kernel reads."""
    if w_q.dim() != 2:
        raise ValueError(f"w_q must be [K, N], got {tuple(w_q.shape)}")
    k, _ = w_q.shape
    if w_q.stride() != (1, k):
        raise ValueError(f"w_q must be the [K, N] view of [N, K] storage, strides (1, {k}); "
                         f"got strides {w_q.stride()} (build it with k_major)")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / a), -127, 127) as int8: an f32 division and
    round-half-to-even, as jnp.round and the kernel do."""
    return torch.clamp(torch.round(x.float() / a_scale), -127, 127).to(torch.int8)


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-call activation scale max(max|x|, 1e-6) / 127 as a one-element
    f32 tensor on x's device (no host sync)."""
    amax = torch.clamp(x.float().abs().amax(), min=1e-6)
    # a tensor divisor: on a card PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, not the IEEE quotient
    return (amax / torch.full_like(amax, 127.0)).reshape(1)


def int_matmul(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of s8 operands: int64 on the CPU; on a card,
    float64, whose sums stay exact below 2^53."""
    if xq.is_cuda:
        return torch.matmul(xq.double(), w_q.double()).to(torch.int32)
    return torch.matmul(xq.long(), w_q.long()).to(torch.int32)


def dequantize(yq: torch.Tensor, a_scale: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """float(yq) * (a * w_scale) + b, in f32, cast to dtype (wan_dit.py:123-126)."""
    y = yq.float() * (a_scale.float() * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def int8_linear_plain(x, w_q, w_scale, a_scale, bias=None) -> torch.Tensor:
    if x.is_cuda:
        PLAIN_ON_CUDA["int8_linear"] += 1
    a_scale = a_scale.float().reshape(())
    yq = int_matmul(quantize(x, a_scale), w_q)
    return dequantize(yq, a_scale, w_scale, bias, x.dtype)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _check(x, w_q, w_scale, a_scale, bias) -> None:
    k, n = w_q.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match w_q {tuple(w_q.shape)}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32 \
            or a_scale.dtype != torch.float32:
        raise ValueError("w_q must be int8, w_scale and a_scale float32")
    if w_scale.shape != (n,) or a_scale.numel() != 1:
        raise ValueError(f"w_scale {tuple(w_scale.shape)} / a_scale {tuple(a_scale.shape)}")
    if bias is not None and (bias.shape != (n,) or bias.dtype not in _BIAS_KIND):
        raise ValueError(f"bias must be [{n}] bf16 or f32, got {tuple(bias.shape)} {bias.dtype}")
    if k % 16 or n % 16:
        raise ValueError(f"K {k} and N {n} must be multiples of 16")
    check_weight_layout(w_q)
    for name, t in (("x", x), ("w_q", w_q), ("w_scale", w_scale), ("a_scale", a_scale),
                    ("bias", bias)):
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} is not on x's CUDA device")
        if name != "w_q" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and name in ("x", "w_q"):
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(x, w_q, w_scale, a_scale, bias=None, fault: int = 0) -> torch.Tensor:
    lib = _load()
    k, n = w_q.shape
    m = x.numel() // k
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)  # the quanta of x
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rtv_int8_linear(
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), a_scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        0 if bias is None else _BIAS_KIND[bias.dtype], out.data_ptr(), xq.data_ptr(),
        m, k, n, fault, stream)
    if err != 0:
        raise RuntimeError(f"rtv_int8_linear launch failed: cudaError {err}")
    return out


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                a_scale: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] @ int8 w_q [K, N] with the fused quantise and dequantise;
    returns [..., N] in x's dtype. a_scale: one-element f32 tensor. On a card
    w_q must be the K-major view (`k_major`)."""
    if not x.is_cuda:
        return int8_linear_plain(x, w_q, w_scale, a_scale, bias)
    _check(x, w_q, w_scale, a_scale, bias)
    out = _launch(x, w_q, w_scale, a_scale, bias)
    LAUNCHES["int8_linear"] += 1
    if w_q.shape[0] > K_RESIDENT_MAX:
        LAUNCHES["int8_linear_k_tiled"] += 1
    return out


def int8_linear_ops(m: int, k: int, n: int) -> float:
    """Integer operations of one call (a multiply and an add per term)."""
    return 2.0 * m * k * n


def int8_linear_bytes(m: int, k: int, n: int, bias: bool = True) -> float:
    """Bytes one call must move: x (bf16) and w_q (s8) read once, w_scale and
    bias (f32/bf16) read once, y (bf16) written once."""
    return 2.0 * m * k + k * n + 4.0 * n + (2.0 * n if bias else 0.0) + 2.0 * m * n
