"""Hand-written row kernels for the DiT layer's norm glue: build, bind, launch, count.

`csrc/dit_norm_sm90.cu` holds two CUDA kernels, each one pass over the rows
of a norm site of `models/wan_dit.py::_block`, where PyTorch runs a chain of
separate f32 ops that each read or write the whole activation:

  * `add_ln_modulate`: the optional residual tokens + y (y first times the
    per-frame gate), written as the new tokens; then the LayerNorm of the
    row, and the per-frame AdaLN x * (1 + scale) + shift or the affine
    x * weight + bias. It serves a layer's first norm (msa), the
    self-attention residual with norm3, the cross-attention residual with
    the FFN's norm, the FFN's closing residual (the residual alone) and the
    head's norm;
  * `qk_norm_rope`: the q/k RMSNorm over the whole width and RoPE on the
    interleaved pairs, q and k read with a row stride straight out of the
    fused qkv output, written contiguous as [B, L, N, Dh]; the
    cross-attention's q takes it without RoPE.

No Pallas TPU kernel stands behind them: the JAX package leaves these ops to
XLA's fusion. The plain chains (`wan_dit.layer_norm`, `modulate`, `gate`,
`rms_norm`, `rope.rope_apply_fused`) stay the CPU path and the reference;
the kernels make every one of their roundings in the same order, and only
the order of the statistics' sums differs (the source's note).
`add_ln_modulate_plain` and `qk_norm_rope_plain` are the same chains in the
kernels' interface, which a CPU tensor takes.

The kernels have no backward. `engages` is the condition under which
`_block` sends a site here: x a bf16 CUDA tensor of a width the launch
takes, nothing that needs a gradient, the frame count an int (a sequence-
parallel shard's tensor of frame indices takes the plain chain) and, for
q/k, no tensor parallelism (`rms_norm_tp` sums over the tp group) and a head
dim that is a multiple of 8. `LAUNCHES` counts kernel launches,
`PLAIN_ON_CUDA` the calls on a card that `engages` sent to the plain chain.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from realtime_video_tpu_torch.models.rope import rope_apply_fused
from realtime_video_tpu_torch.ops import cuda_build
from realtime_video_tpu_torch.utils.device import on_card

SOURCE = cuda_build.CSRC / "dit_norm_sm90.cu"

LAUNCHES: Dict[str, int] = {"add_ln_modulate": 0, "qk_norm_rope": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"add_ln_modulate": 0, "qk_norm_rope": 0}
#: the widest row the launch takes (4 vectors of 8 a thread, 256 threads)
MAX_WIDTH = 8192

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
            ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
            fn = lib.rtv_add_ln_modulate
            fn.argtypes = [ptr] * 5 + [i64] * 2 + [ptr] * 4 + [i32] * 4 + [f32, ptr]
            fn.restype = ctypes.c_int
            fn = lib.rtv_qk_norm_rope
            fn.argtypes = [ptr] * 2 + [i64] + [ptr] * 4 + [i32] + [ptr] * 2 + [i32] * 3 + [f32, ptr]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def engages(kernel: str, x: torch.Tensor, *operands: Optional[torch.Tensor], frames=1,
            tp=None, head_dim: Optional[int] = None) -> bool:
    """Whether `kernel` serves a call on x with the other tensors
    `operands` (None skipped): x a bf16 CUDA tensor whose width the launch
    takes; no tensor that needs a gradient; `frames` an int; no tp group
    (the q/k norm's caller passes its own); `head_dim`, where given, a
    multiple of 8. A call on a card that does not engage is counted in
    PLAIN_ON_CUDA."""
    if not x.is_cuda:
        return False
    d = x.shape[-1]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *operands) if t is not None)
    ok = (x.dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_WIDTH and not grad
          and isinstance(frames, int) and tp is None
          and (head_dim is None or head_dim % 8 == 0))
    if not ok:
        PLAIN_ON_CUDA[kernel] += 1
    return ok


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def add_ln_modulate_plain(x, frames: int, y=None, gate=None, shift=None, scale=None,
                          weight=None, bias=None, eps: float = 1e-6,
                          norm: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(tokens, out): tokens = x + y * gate (x + y without a gate, x without
    y), each per-frame operand [B, F, D] cast to x's dtype; out = the
    LayerNorm of tokens (f32 statistics, rounded to x's dtype) times
    (1 + scale) plus shift, or times weight plus bias, in x's dtype (None
    with norm=False). x, y [B, L, D], L = frames * tokens per frame."""
    b, L, d = x.shape

    def per_frame(t):
        return t[:, :, None, :].to(x.dtype)

    xs = x.reshape(b, frames, L // frames, d)
    if y is not None:
        ys = y.reshape(b, frames, L // frames, d)
        xs = xs + (ys if gate is None else ys * per_frame(gate))
    tokens = xs.reshape(b, L, d)
    if not norm:
        return tokens, None
    xf = xs.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    n = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if shift is not None:
        n = n * (1.0 + per_frame(scale)) + per_frame(shift)
    else:
        if weight is not None:
            n = n * weight.to(x.dtype)
        if bias is not None:
            n = n + bias.to(x.dtype)
    return tokens, n.reshape(b, L, d)


def qk_norm_rope_plain(q, k, q_weight, k_weight, rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                       head_dim: int, eps: float = 1e-6):
    """(q, k) [B, L, N, Dh] from q / k [B, L, D] (k may be None): the RMSNorm
    over D with f32 statistics, rounded to q's dtype, times the weight; then
    RoPE with `rope` = (cos, sin) [L, Dh / 2], or none."""

    def one(x, w):
        xf = x.float()
        n = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)
        n = (n * w.to(x.dtype)).reshape(*x.shape[:-1], -1, head_dim)
        return n if rope is None else rope_apply_fused(n, *rope)

    return one(q, q_weight), None if k is None else one(k, k_weight)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptrs(*tensors: Optional[torch.Tensor]) -> list:
    """Each tensor's data pointer (None for None); raises unless every one
    is 16-byte aligned."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    if any(p is not None and p % 16 for p in ptrs):
        raise ValueError("the kernels' operands must be 16-byte aligned")
    return ptrs


def _dense(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """t in dtype and contiguous, with no torch call where it is both."""
    if t is None:
        return None
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def _rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """x as a [rows, d] view with unit column stride and a row stride that
    keeps 16-byte alignment (a contiguous copy otherwise)."""
    r = x.reshape(-1, d)
    if r.stride(1) != 1 or r.stride(0) % 8:
        r = r.contiguous()
    return r


def add_ln_modulate(x: torch.Tensor, frames: int, y: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None, weight: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
                    norm: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`add_ln_modulate_plain` in one launch on a card: x, y bf16 [B, L, D];
    gate / shift / scale [B, F, D] views (the layer's f32 modulation);
    weight / bias [D]. Returns (tokens, out), both new tensors (tokens is x
    without y)."""
    if not x.is_cuda:
        return add_ln_modulate_plain(x, frames, y, gate, shift, scale, weight, bias, eps, norm)
    b, L, d = x.shape
    if x.dtype != torch.bfloat16 or (y is not None and (y.dtype != x.dtype or y.shape != x.shape)):
        raise ValueError(f"x and y must be bf16 [B, L, D], got {x.dtype} {tuple(x.shape)}")
    if L % frames or (y is None and not norm) or (shift is None) != (scale is None):
        raise ValueError(f"{L} tokens, {frames} frames; y given: {y is not None}, "
                         f"norm {norm}, shift / scale given: {shift is not None} / "
                         f"{scale is not None}")
    gate, shift, scale = (t if t is None or t.dtype == torch.float32 else t.float()
                          for t in (gate, shift, scale))
    mods = [t for t in (gate, shift, scale) if t is not None]
    sb, sf = mods[0].stride()[:2] if mods else (0, 0)
    if sb % 4 or sf % 4 or any(t.shape != (b, frames, d) or t.stride() != (sb, sf, 1)
                               for t in mods):
        raise ValueError("gate, shift and scale must be [B, F, D] views with one pair of "
                         "strides, multiples of 4")
    weight, bias = _dense(weight, x.dtype), _dense(bias, x.dtype)
    x, y = _dense(x, x.dtype), _dense(y, x.dtype)
    tokens = x if y is None else torch.empty_like(x)
    out = torch.empty_like(x) if norm else None
    ptrs = _ptrs(x, y, gate, shift, scale, weight, bias, None if y is None else tokens, out)
    lib = _lib or _load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_card(x):  # the .cu side acts on the current device
        err = lib.rtv_add_ln_modulate(*ptrs[:5], sb, sf, *ptrs[5:], b * L, L, L // frames, d,
                                      eps, stream)
    if err != 0:
        raise RuntimeError(f"rtv_add_ln_modulate launch failed: cudaError {err}")
    LAUNCHES["add_ln_modulate"] += 1
    return tokens, out


def qk_norm_rope(q: torch.Tensor, k: Optional[torch.Tensor], q_weight: torch.Tensor,
                 k_weight: Optional[torch.Tensor],
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]], head_dim: int,
                 eps: float = 1e-6):
    """`qk_norm_rope_plain` in one launch on a card: q and k [B, L, D] bf16,
    rows at one stride (the thirds of the qkv output, or contiguous), the
    weights [D], (cos, sin) f32 [L, head_dim / 2] or None. Returns (q, k)
    contiguous [B, L, N, Dh] (k None without k)."""
    if not q.is_cuda:
        return qk_norm_rope_plain(q, k, q_weight, k_weight, rope, head_dim, eps)
    b, L, d = q.shape
    if q.dtype != torch.bfloat16 or (k is not None and (k.dtype != q.dtype or k.shape != q.shape)):
        raise ValueError(f"q and k must be bf16 [B, L, D], got {q.dtype} {tuple(q.shape)}")
    if head_dim % 8 or d % head_dim:
        raise ValueError(f"head_dim {head_dim} must divide {d} and be a multiple of 8")
    q = _rows(q, d)
    k = None if k is None else _rows(k, d)
    if k is not None and k.stride(0) != q.stride(0):
        q, k = q.contiguous(), k.contiguous()
    cos, sin = (None, None) if rope is None else (_dense(t, torch.float32) for t in rope)
    if cos is not None and (cos.shape != (L, head_dim // 2) or sin.shape != cos.shape):
        raise ValueError(f"rope tables {tuple(cos.shape)}, want [{L}, {head_dim // 2}]")
    q_weight = _dense(q_weight, q.dtype)
    k_weight = None if k is None else _dense(k_weight, q.dtype)
    q_out = torch.empty((b, L, d // head_dim, head_dim), dtype=q.dtype, device=q.device)
    k_out = None if k is None else torch.empty_like(q_out)
    ptrs = _ptrs(q, k, q_weight, k_weight, cos, sin, q_out, k_out)
    lib = _lib or _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with on_card(q):
        err = lib.rtv_qk_norm_rope(*ptrs[:2], q.stride(0), *ptrs[2:6], head_dim // 2,
                                   *ptrs[6:], b * L, L, d, eps, stream)
    if err != 0:
        raise RuntimeError(f"rtv_qk_norm_rope launch failed: cudaError {err}")
    LAUNCHES["qk_norm_rope"] += 1
    return q_out, k_out


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------


def add_ln_modulate_bytes(rows: int, d: int, residual: bool, norm: bool = True,
                          frames: int = 1, per_frame: int = 2) -> float:
    """Bytes one call must move: x (and y) read, the new tokens (with y) and
    the normalised rows written, in bf16; `per_frame` f32 [frames, D]
    operands read once."""
    row = 2 * (1 + 2 * residual + norm)
    return float(rows * d * row + per_frame * frames * d * 4)


def qk_norm_rope_bytes(rows: int, d: int, tensors: int = 2, rope_half: int = 0,
                       positions: int = 0) -> float:
    """Bytes one call must move: each of `tensors` [rows, D] read and written
    in bf16, its weight read; the f32 cos / sin tables [positions, half]
    read once."""
    return float(tensors * (rows * d * 4 + d * 2) + 2 * positions * rope_half * 4)
