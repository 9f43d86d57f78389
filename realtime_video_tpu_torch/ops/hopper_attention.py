"""Hand-written Hopper attention: build, bind, launch, count.

`csrc/attention.cu` holds one CUDA kernel that replaces two Pallas TPU
kernels of `realtime_video_tpu/ops/pallas_attention.py`:

  * `window_attention` -- `_staticmax_kernel` (K1): softmax over KV columns in
    [lo, hi) with a static logit bound M; when M >= 64 the same launch keeps a
    running max instead (the `_flash_kernel` fallback the JAX package takes
    with `lax.cond`). M lives in device memory and the kernel reads it, so the
    choice costs no host sync.
  * `block_causal_attention` -- `_flash_kernel` (K2) in block-causal mode:
    kv < min(ends[q], kv_len) with ends[q] = (q // block_tokens + 1) *
    block_tokens, an optional local window, and the diagonal.

Both take q [B, Lq, N, D], k/v [B, Lk, N, D]. A tensor on the CPU goes to the
plain PyTorch version beside the kernel (`window_attention_plain`,
`block_causal_attention_plain`); a CUDA tensor goes to the kernel or the call
raises. The kernel is compiled with nvcc for sm_90a into a shared library with
a plain C interface at first use (`ops/cuda_build.py`), and bound with ctypes.

`LAUNCHES` counts kernel launches per entry point; nothing else touches it.
`PLAIN_ON_CUDA` counts calls of a plain version on a CUDA tensor, which the
serving path never makes (only a comparison against the kernel does).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from realtime_video_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634
#: exp2(s - M) cannot underflow a whole row while M stays below this bound
#: (pallas_attention.py:81-89); above it the kernel keeps a running max.
STATIC_MAX_LIMIT = 64.0
NEG_INF = -1e30

_MODE_WINDOW = 0
_MODE_BLOCK_CAUSAL = 1

SOURCE = cuda_build.CSRC / "attention.cu"

#: kernel launches per entry point (plain-version calls are not counted)
LAUNCHES: Dict[str, int] = {"window": 0, "block_causal": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"window": 0, "block_causal": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        PLAIN_ON_CUDA[key] = 0


def build() -> Path:
    """Compile csrc/attention.cu if its content-keyed library is missing and
    return the library path."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.rtv_attention
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions (masked f32 softmax), the reference the kernel is held to
# ---------------------------------------------------------------------------


def _masked_softmax_attention(q, k, v, valid, scale: float) -> torch.Tensor:
    """q [B,Lq,N,D], k/v [B,Lk,N,D], valid broadcastable to [Lq, Lk]."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def window_attention_plain(q, k, v, lo: int, hi: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        PLAIN_ON_CUDA["window"] += 1
    col = torch.arange(k.shape[1], device=q.device)
    valid = ((col >= lo) & (col < hi))[None, :]
    return _masked_softmax_attention(q, k, v, valid, scale)


def block_causal_mask(lq: int, lk: int, block_tokens: int, kv_len: int,
                      local_window: Optional[int], device) -> torch.Tensor:
    """[Lq, Lk] bool: col < min(ends[q], kv_len) (& col >= ends - window) | q == col."""
    qi = torch.arange(lq, device=device)[:, None]
    col = torch.arange(lk, device=device)[None, :]
    ends = (qi // block_tokens + 1) * block_tokens
    valid = col < torch.clamp(ends, max=kv_len)
    if local_window is not None:
        valid = valid & (col >= ends - local_window)
    return valid | (qi == col)


def block_causal_attention_plain(q, k, v, block_tokens: int,
                                 local_window: Optional[int] = None,
                                 scale: Optional[float] = None) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        PLAIN_ON_CUDA["block_causal"] += 1
    valid = block_causal_mask(q.shape[1], k.shape[1], block_tokens, k.shape[1],
                              local_window, q.device)
    return _masked_softmax_attention(q, k, v, valid, scale)


def prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Fold softmax scale and log2(e) into q (the kernel exponentiates with exp2)."""
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)


def logit_bound(q_scaled: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[1] f32 upper bound on q.k over all row pairs: max row norm of the
    pre-scaled q times max row norm of k, + 1e-3 (pallas_attention.py:437-442).
    Stays on the device."""
    qn = q_scaled.float().square().sum(-1).amax().sqrt()
    kn = k.float().square().sum(-1).amax().sqrt()
    return (qn * kn + 1e-3).reshape(1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not on a CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, L, N, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, _, n, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d != 128:
        raise ValueError(f"head dim {d} not supported by the kernel (128 only)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")


def _launch(q, k, v, m_bound, mode, lo, hi, block_tokens, kv_len, local_window):
    lib = _load()
    b, lq, n, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rtv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, k.shape[1],
        n, d, None if m_bound is None else m_bound.data_ptr(), mode, lo, hi,
        block_tokens, kv_len, local_window, stream)
    if err != 0:
        raise RuntimeError(f"rtv_attention launch failed: cudaError {err}")
    return out


def window_attention(q, k, v, lo: int, hi: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attend q to KV positions [lo, hi) (host ints). K1, with K2's running
    max as the in-kernel fallback when the logit bound is >= 64."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lk = k.shape[1]
    lo, hi = max(int(lo), 0), min(int(hi), lk)
    if not q.is_cuda:
        return window_attention_plain(q, k, v, lo, hi, scale)
    _check(q, k, v)
    qs = prescale(q, scale)
    m_bound = logit_bound(qs, k)
    out = _launch(qs, k, v, m_bound, _MODE_WINDOW, lo, hi, 1, lk, -1)
    LAUNCHES["window"] += 1
    return out


def block_causal_attention(q, k, v, block_tokens: int,
                           local_window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise-causal self attention (K2, block_causal mode)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if block_tokens <= 0:
        raise ValueError(f"block_tokens must be positive, got {block_tokens}")
    if not q.is_cuda:
        return block_causal_attention_plain(q, k, v, block_tokens, local_window, scale)
    _check(q, k, v)
    if q.shape[1] != k.shape[1]:
        raise ValueError("block-causal attention needs Lq == Lk")
    if local_window is not None and local_window <= 0:
        raise ValueError(f"local_window must be positive, got {local_window}")
    qs = prescale(q, scale)
    out = _launch(qs, k, v, None, _MODE_BLOCK_CAUSAL, 0, k.shape[1], int(block_tokens),
                  k.shape[1], -1 if local_window is None else int(local_window))
    LAUNCHES["block_causal"] += 1
    return out


def window_flops(lq: int, lo: int, hi: int, heads: int, head_dim: int,
                 batch: int = 1) -> float:
    """FLOP of QK^T and PV over the live columns [lo, hi) of a window call."""
    return 4.0 * batch * heads * head_dim * lq * max(hi - lo, 0)


def block_causal_flops(length: int, block_tokens: int, heads: int, head_dim: int,
                       local_window: Optional[int] = None, batch: int = 1) -> float:
    """FLOP of QK^T and PV over the live (query, key) pairs of a
    block-causal call: the block triangle, the local window and the diagonal."""
    pairs = 0
    for start in range(0, length, block_tokens):
        stop = min(start + block_tokens, length)
        ends = start + block_tokens  # the window hangs off the unclamped end
        first = 0 if local_window is None else max(ends - local_window, 0)
        pairs += (stop - start) * max(stop - first, 0)
        pairs += max(min(first, stop) - start, 0)  # rows left of their window
    return 4.0 * batch * heads * head_dim * pairs


#: Kernel against plain version on the same bf16 inputs. Both round P to bf16
#: for the PV product, the kernel before normalising and the plain version
#: after, and both round the output to bf16; the rest is summation order.
#: Elementwise |kernel - plain| <= atol + RTOL * |plain|, with RTOL two bf16
#: ulps (the output roundings) and atol ATOL, a few times the largest
#: difference at unit scale, where the softmax is spread and the P roundings
#: average out. A sharp softmax passes single v values through, and there the
#: P roundings move an output by up to 2^-7 * max|v|: pass sharp_atol(v).
#: And ||kernel - plain|| / ||plain|| <= REL_FRO in every case. At the
#: self-attention shape (7800 live columns) dropping 16 of them moves the
#: relative error to about 4%, well past REL_FRO.
ATOL, RTOL, REL_FRO = 2e-3, 1.6e-2, 1e-2


def sharp_atol(v: torch.Tensor) -> float:
    """Elementwise bound of the two P roundings when the softmax is sharp."""
    return 2.0 ** -7 * v.float().abs().max().item()


def agreement(got: torch.Tensor, want: torch.Tensor,
              atol: float = ATOL) -> Dict[str, object]:
    """Compare a kernel output with its plain version under the bounds above."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rel_fro = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    elementwise = bool((diff <= atol + RTOL * want.abs()).all())
    return {"max_abs_err": diff.max().item(), "rel_fro_err": rel_fro, "atol": atol,
            "within_tol": bool(torch.isfinite(got).all()) and elementwise
            and rel_fro <= REL_FRO}
