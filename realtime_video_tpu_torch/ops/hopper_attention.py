"""Hand-written Hopper attention: switches, dispatch, build, bind, launch, count.

`csrc/attention_sm90.cu` (wgmma, TMA, a warp-specialised pipeline) replaces
the Pallas TPU kernels of `realtime_video_tpu/ops/pallas_attention.py`:

  * K1 `_staticmax_kernel`: softmax over KV columns in [lo, hi) with a static
    logit bound M; when M >= 64 the same launch keeps a running max instead
    (the `_flash_kernel` fallback the JAX package takes with `lax.cond`). M
    comes from a pre-pass kernel (`logit_bound_maxima`) that leaves two
    maxima in device memory; the main kernel forms M from them, so the choice
    costs no host sync.
  * K2 `_flash_kernel` in window mode (K1's fallback, or every window call
    with STATIC_MAX off) and in block-causal mode: kv < min(ends[q], kv_len)
    with ends[q] = (q // block_tokens + 1) * block_tokens, an optional local
    window, and the diagonal.
  * K2-int8, `_flash_kernel`'s `int8_qk` branch (the SageAttention analog):
    a pre-pass (`int8_qk_prepass`) prescales raw q and quantises it, and k
    minus the mean of its `bk`-row segment (`segment_rows`), to s8 with
    per-row f32 scales; the same kernel, with an s8 QK^T (wgmma m64n128k32),
    takes the sums to f32 by sq * sk and runs K2's softmax and bf16 PV.
  * K6a `_skew_kernel` and K6b `_staticmax_skew_kernel`: K2's and K1's window
    math with V lagging K by one step. The kernel issues the QK^T of tile j
    with the PV of tile j-1 and runs tile j's softmax while that PV is in
    flight, the Hopper form of the skew, so `window_skew` launches it with
    the running max and `window_skew_staticmax` with the bound pre-pass's
    static max (and its in-launch fallback at M >= 64).
  * Teacher forcing, which has no TPU kernel (the JAX package runs
    `teacher_forcing_mask` through dense XLA): the same kernel's mode 2
    over the sequence [clean | noisy], in bf16 with K2's running max. A
    query tile walks the union of its two key ranges
    (`csrc/attention_mask.cuh`); no dense mask is built on the card.

The bf16 launches take raw q and fold the prescale (`prescale`, bf16(q *
bf16(scale * log2 e))) into their Q tile, and the int8 pre-pass into its
quantiser, with the same rounding: no route runs a torch op before a launch.

The switches are module attributes of the JAX module's names, read from the
same environment variables at import and read again by every call, so a test
sets them as tests/test_pallas_attention.py sets `pat.INT8_QK`:

  INT8_QK (RTV_ATTN_INT8), SKEW (RTV_ATTN_SKEW), SKEW2 (RTV_ATTN_SKEW2),
  STATIC_MAX (RTV_ATTN_STATICMAX, default on), BK (RTV_ATTN_BK).

`window_route` keeps `decode_attention`'s precedence: SKEW2 and not INT8_QK
-> K6b (with its M >= 64 running-max fallback); else SKEW and not INT8_QK ->
K6a; else STATIC_MAX and not INT8_QK -> K1 with its fallback; else the
running-max window, int8 under INT8_QK. Block-causal calls take K2, int8
under INT8_QK. BK changes a result: under INT8_QK it sets the width of the
mean segments. RTV_ATTN_BQ, _BKM, _SKEW2_BK and _NOPAD do not apply: they
size or pad the TPU's VMEM tiles and change no result there, and these
kernels never pad.

Every entry takes q [B, Lq, N, D], k/v [B, Lk, N, D]. A tensor on the CPU
goes to the plain PyTorch version beside the kernel; a CUDA tensor goes to
the kernel or the call raises. The source is compiled with nvcc for sm_90a
into a shared library with a plain C interface at first use
(`ops/cuda_build.py`), and bound with ctypes.

The gradient. When q, k or v requires grad, `window_attention` (the
`window` route) and `block_causal_attention` (the `block_causal` route) go
through `KernelAttention`, a `torch.autograd.Function`: its forward is the
same bf16 launch, which then also writes each row's log-sum-exp (f32 [B, N,
Lq]; a null pointer writes nothing, so the serving calls are unchanged), and
its backward is `csrc/attention_bwd_sm90.cu` (wgmma, TMA, warp-specialised;
see its header), which recomputes P from that LSE. On the CPU both are
plain versions (`attention_forward_plain`, `attention_backward_plain`). The
int8 and skew routes have no backward and raise when a gradient is needed.
The JAX package has no such kernel: its Pallas attention cannot be
differentiated, and its trainer differentiates the dense XLA attention,
whose gradient the plain backward computes.

`LAUNCHES` counts kernel launches per route (one int8 call = its pre-pass
and its main kernel; one backward = its D pre-pass and its dQ and dK/dV
passes, under `window_bwd` / `block_causal_bwd` / `teacher_forcing_bwd`),
`PREPASS_LAUNCHES["logit_bound"]` those of the logit-bound pre-pass; nothing
else touches them. `PLAIN_ON_CUDA` counts calls of a plain version on a CUDA
tensor (a plain backward under its forward's key), which the serving and
training paths never make (only a comparison against the kernel does).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os as _os
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from realtime_video_tpu_torch.ops import cuda_build
from realtime_video_tpu_torch.parallel import collectives as coll
from realtime_video_tpu_torch.utils.device import on_card

LOG2E = 1.4426950408889634
#: exp2(s - M) cannot underflow a whole row while M stays below this bound
#: (pallas_attention.py:81-89); above it the kernel keeps a running max.
STATIC_MAX_LIMIT = 64.0
NEG_INF = -1e30

# ---- switches (pallas_attention.py:49-90) ----
BK = int(_os.getenv("RTV_ATTN_BK", "1024"))
INT8_QK = _os.getenv("RTV_ATTN_INT8", "0") in ("1", "true")
SKEW = _os.getenv("RTV_ATTN_SKEW", "0") in ("1", "true")
SKEW2 = _os.getenv("RTV_ATTN_SKEW2", "0") in ("1", "true")
STATIC_MAX = _os.getenv("RTV_ATTN_STATICMAX", "1") in ("1", "true")

_MODE_WINDOW = 0
_MODE_BLOCK_CAUSAL = 1
_MODE_TEACHER_FORCING = 2

#: planted faults for the checks that must catch them (kernel argument)
FAULT_K_SCALE_SHIFT = 2  # int8: the last segment's columns take the next row's k scale
FAULT_STALE_RING_STAGE = 3  # the last K and V ring stages hold the previous tile
FAULT_DROP_D = 1  # backward: dS = P * dP, the rowsum(dO * O) term dropped
# teacher forcing (csrc/attention_mask.cuh), forward and backward
FAULT_TF_LEAK = 4  # a noisy block also sees its own clean block
FAULT_TF_SHORT = 5  # the noisy range ends 16 keys short
FAULT_TF_DROP_CLEAN = 6  # noisy blocks j >= 1 see no clean keys
FAULT_TF_SKIP_NOISY_Q = 7  # backward: a clean key's dK/dV skips the later noisy queries

SM90_SOURCE = cuda_build.CSRC / "attention_sm90.cu"
BWD_SOURCE = cuda_build.CSRC / "attention_bwd_sm90.cu"
SOURCES = (SM90_SOURCE, BWD_SOURCE)

WINDOW_ROUTES = ("window", "window_int8qk", "window_skew", "window_skew_staticmax")
BLOCK_CAUSAL_ROUTES = ("block_causal", "block_causal_int8qk")
BACKWARD_KEYS = ("window_bwd", "block_causal_bwd", "teacher_forcing_bwd")
#: kernel launches per route (plain-version calls are not counted)
LAUNCHES: Dict[str, int] = {r: 0 for r in WINDOW_ROUTES + BLOCK_CAUSAL_ROUTES
                            + ("teacher_forcing",) + BACKWARD_KEYS}
#: launches of the logit-bound pre-pass kernel (part of the `window` route)
PREPASS_LAUNCHES: Dict[str, int] = {"logit_bound": 0}
PLAIN_ON_CUDA: Dict[str, int] = {"window": 0, "block_causal": 0, "teacher_forcing": 0}

_lib = None
_bwd_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for d in (LAUNCHES, PREPASS_LAUNCHES, PLAIN_ON_CUDA):
        for key in d:
            d[key] = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def segment_rows(lk: int) -> int:
    """The int8 mode's mean segment width: the bk that
    pallas_attention._tiles_for gives for the current BK."""
    return min(BK, _round_up(lk, 128))


def window_route() -> str:
    """The route a window call takes under the current switches, in
    pallas_attention.decode_attention's precedence."""
    if INT8_QK:
        return "window_int8qk"
    if SKEW2:
        return "window_skew_staticmax"
    return "window_skew" if SKEW else "window"


def static_max(route: str) -> bool:
    """Whether a window route bounds the softmax by the static logit bound
    (falling back to the running max in the kernel when it is >= 64)."""
    return route == "window_skew_staticmax" or (route == "window" and STATIC_MAX)


def block_causal_route() -> str:
    """The route of a block-causal call (pallas_attention.prefill_attention)."""
    return "block_causal_int8qk" if INT8_QK else "block_causal"


def build() -> Dict[Path, Path]:
    """Compile the sources whose content-keyed libraries are missing (both
    nvcc runs at once); return {source: library path}."""
    return cuda_build.build_all(SOURCES)


def _load():
    """The wgmma library: the attention kernel (bf16 and int8 QK^T) and its
    two pre-passes."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[SM90_SOURCE]))
            p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
            lib.rtv_attention_sm90.argtypes = [p] * 4 + [i] * 5 + [f, p, p] + [i] * 7 + [p]
            lib.rtv_attention_sm90.restype = i
            lib.rtv_attention_sm90_int8.argtypes = [p] * 6 + [i] * 14 + [p]
            lib.rtv_attention_sm90_int8.restype = i
            lib.rtv_logit_bound.argtypes = [p] * 3 + [ll, ll, i, f, p]
            lib.rtv_logit_bound.restype = i
            lib.rtv_int8_qk_quantize.argtypes = [p] * 7 + [i] * 6 + [f, i, p]
            lib.rtv_int8_qk_quantize.restype = i
            _lib = lib
    return _lib


def _load_bwd():
    """The backward library (csrc/attention_bwd_sm90.cu)."""
    global _bwd_lib
    with _lib_lock:
        if _bwd_lib is None:
            lib = ctypes.CDLL(str(build()[BWD_SOURCE]))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.rtv_attention_bwd_sm90.argtypes = [p] * 11 + [i] * 5 + [f] + [i] * 8 + [p]
            lib.rtv_attention_bwd_sm90.restype = i
            _bwd_lib = lib
    return _bwd_lib


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


def _window_mask(lk: int, lo: int, hi: int, device) -> torch.Tensor:
    col = torch.arange(lk, device=device)
    return ((col >= lo) & (col < hi))[None, :]


def window_attention_plain(q, k, v, lo: int, hi: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of every bf16 window route (K1, K2 window, K6a, K6b)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        PLAIN_ON_CUDA["window"] += 1
    return _masked_softmax_attention(q, k, v, _window_mask(k.shape[1], lo, hi, q.device),
                                     scale)


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


def teacher_forcing_dense(half_len: int, block_tokens: int, device=None) -> torch.Tensor:
    """[2L, 2L] bool over the sequence [clean | noisy], L = half_len: a clean
    query sees the clean keys up to the end of its block; a noisy query of
    block j sees its own noisy block [L + jB, L + (j + 1)B) and the clean
    keys of the earlier blocks [0, jB); and the diagonal
    (ops/attention.py:147-173 of the JAX package)."""
    n = 2 * half_len
    q_idx = torch.arange(n, device=device)[:, None]
    kv_idx = torch.arange(n, device=device)[None, :]
    clean_q = q_idx < half_len
    clean_mask = clean_q & (kv_idx < (q_idx // block_tokens + 1) * block_tokens)
    noise_block = (q_idx - half_len) // block_tokens
    nn_start = half_len + noise_block * block_tokens
    own = (kv_idx >= nn_start) & (kv_idx < nn_start + block_tokens)
    earlier = kv_idx < noise_block * block_tokens
    return clean_mask | (~clean_q & (own | earlier)) | (q_idx == kv_idx)


@dataclasses.dataclass(frozen=True)
class Mask:
    """The keys a call attends to: the window [lo, hi) (mode 0; unmasked is
    [0, Lk)), block-causal (mode 1: key < min(ends[q], kv_len), optionally
    key >= ends[q] - local_window, and the diagonal) or teacher forcing (mode
    2: `teacher_forcing_dense` with L = kv_len, B = block_tokens)."""
    mode: int
    lo: int = 0
    hi: int = 0
    block_tokens: int = 1
    kv_len: int = 0
    local_window: Optional[int] = None

    @classmethod
    def window(cls, lo: int, hi: int) -> "Mask":
        return cls(_MODE_WINDOW, lo, hi)

    @classmethod
    def block_causal(cls, lk: int, block_tokens: int,
                     local_window: Optional[int] = None) -> "Mask":
        return cls(_MODE_BLOCK_CAUSAL, 0, lk, block_tokens, lk, local_window)

    @classmethod
    def teacher_forcing(cls, half_len: int, block_tokens: int) -> "Mask":
        """[clean | noisy], each half `half_len` tokens in blocks of
        `block_tokens`; the kernel takes half_len a multiple of block_tokens
        (every clean block whole)."""
        if block_tokens <= 0 or half_len <= 0 or half_len % block_tokens:
            raise ValueError(f"teacher forcing needs half_len ({half_len}) a positive "
                             f"multiple of block_tokens ({block_tokens})")
        return cls(_MODE_TEACHER_FORCING, 0, 2 * half_len, block_tokens, half_len)

    @property
    def key(self) -> str:
        """The route name the call counts under."""
        return ("window", "block_causal", "teacher_forcing")[self.mode]

    def dense(self, lq: int, lk: int, device) -> torch.Tensor:
        """[Lq, Lk] bool, True = attend."""
        if self.mode == _MODE_WINDOW:
            return _window_mask(lk, self.lo, self.hi, device).expand(lq, lk)
        if self.mode == _MODE_TEACHER_FORCING:
            if lq != self.hi or lk != self.hi:
                raise ValueError(f"the teacher-forcing mask is {self.hi} x {self.hi}, "
                                 f"not {lq} x {lk}")
            return teacher_forcing_dense(self.kv_len, self.block_tokens, device)
        return block_causal_mask(lq, lk, self.block_tokens, self.kv_len, self.local_window,
                                 device)

    def kernel_args(self) -> Tuple[int, int, int, int, int, int]:
        """(mode, lo, hi, block_tokens, kv_len, local_window or -1) of a launch
        (teacher forcing: kv_len is L, the half length)."""
        return (self.mode, self.lo, self.hi, self.block_tokens, self.kv_len,
                -1 if self.local_window is None else self.local_window)


def attention_forward_plain(q, k, v, mask: Mask, scale: float):
    """(out, lse): the plain forward and each row's log-sum-exp of the scaled,
    masked scores (f32 [B, N, Lq], natural log; NEG_INF masking, so a row
    with no live key has lse ~ NEG_INF)."""
    if q.is_cuda:
        PLAIN_ON_CUDA[mask.key] += 1
    valid = mask.dense(q.shape[1], k.shape[1], q.device)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(torch.where(valid, logits, torch.full_like(logits, NEG_INF)), -1)
    return _masked_softmax_attention(q, k, v, valid, scale), lse


def attention_backward_plain(q, k, v, o, do, lse, scale: float, mask: Mask,
                             heads_per_chunk: int = 4):
    """(dq, dk, dv) by the recompute formulas of the backward kernel, dense,
    in f32: S = scale q k^T, P = exp(S - lse), dP = dO v^T, D = rowsum(dO *
    o), dS = P (dP - D) on live pairs, dv = P^T dO, dk = scale dS^T q, dq =
    scale dS k. A row with no live key is uniform under NEG_INF masking, as
    the dense softmax makes it (its dS is 0, its P^T dO is not); the kernel
    gives it zero gradients, and no such row occurs on the training path.
    Heads go in chunks so the [Lq, Lk] temporaries stay small at training
    shapes."""
    if q.is_cuda:
        PLAIN_ON_CUDA[mask.key] += 1
    lq, lk = q.shape[1], k.shape[1]
    valid = mask.dense(lq, lk, q.device)
    row_live = valid.any(-1, keepdim=True)
    dof, of = do.float(), o.float()
    delta = (dof * of).sum(-1).transpose(1, 2)  # [B, N, Lq]
    dq, dk, dv = [], [], []
    for h0 in range(0, q.shape[2], heads_per_chunk):
        hs = slice(h0, h0 + heads_per_chunk)
        qf, kf, vf = q[:, :, hs].float(), k[:, :, hs].float(), v[:, :, hs].float()
        dofh = dof[:, :, hs]
        s = torch.einsum("bqnd,bknd->bnqk", qf, kf) * scale
        p = torch.exp(torch.where(valid, s, torch.full_like(s, NEG_INF)) - lse[:, hs, :, None])
        p = torch.where(row_live, p, torch.full_like(p, 1.0 / lk))
        dp = torch.einsum("bqnd,bknd->bnqk", dofh, vf)
        ds = torch.where(valid, p * (dp - delta[:, hs, :, None]), torch.zeros_like(p))
        dv.append(torch.einsum("bnqk,bqnd->bknd", p, dofh))
        dk.append(torch.einsum("bnqk,bqnd->bknd", ds, qf) * scale)
        dq.append(torch.einsum("bnqk,bknd->bqnd", ds, kf) * scale)
        del s, p, dp, ds
    return (torch.cat(dq, 2).to(q.dtype), torch.cat(dk, 2).to(k.dtype),
            torch.cat(dv, 2).to(v.dtype))


def kernel_backward_plain(q, k, v, o, do, scale: float, mask: Mask):
    """(dq, dk, dv) of the function the kernels compute, by the plain
    versions alone: the forward scores bf16(q * c) k^T in log2 units, c =
    qscale(scale) (0.32% above scale * log2 e at head dim 128), so this runs
    the plain forward and backward on q prescaled as the kernel rounds it,
    at scale 1 / log2 e, with the plain forward's own lse, and carries dq
    through the prescale (times c, in q's dtype as `prescale` rounds it:
    qscale(scale) for bf16, so f32 inputs give the exact-scale gradient).
    The reference for the backward kernel, given the kernel's o (its D
    term) and nothing else of the kernel's."""
    qc = prescale(q, scale)
    inv = 1.0 / LOG2E
    _, lse = attention_forward_plain(qc, k, v, mask, inv)
    dqc, dk, dv = attention_backward_plain(qc, k, v, o, do, lse, inv, mask)
    c = float(torch.tensor(scale * LOG2E, dtype=q.dtype))
    return (dqc.float() * c).to(q.dtype), dk, dv


def prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Fold softmax scale and log2(e) into q (the kernel exponentiates with exp2)."""
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)


@functools.lru_cache(maxsize=64)
def qscale(scale: float) -> float:
    """c = bf16(scale * log2(e)), the factor `prescale` multiplies q by, as
    the float the wgmma kernel and its bound pre-pass take."""
    return float(torch.tensor(scale * LOG2E, dtype=torch.bfloat16))


def logit_bound(q_scaled: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[1] f32 upper bound on q.k over all row pairs: max row norm of the
    pre-scaled q times max row norm of k, + 1e-3 (pallas_attention.py:437-442).
    Stays on the device. (A reference: the kernel's comes from
    `logit_bound_maxima`.)"""
    qn = q_scaled.float().square().sum(-1).amax().sqrt()
    kn = k.float().square().sum(-1).amax().sqrt()
    return (qn * kn + 1e-3).reshape(1)


def logit_bound_maxima_plain(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """[2] f32: max over rows of |prescale(q, scale)|^2, and of |k|^2 (all of
    k's rows, not only a window's). The plain version of the bound pre-pass."""
    qn2 = prescale(q, scale).float().square().sum(-1).amax()
    kn2 = k.float().square().sum(-1).amax()
    return torch.stack([qn2, kn2])


def logit_bound_from_maxima(maxima: torch.Tensor) -> torch.Tensor:
    """[1] f32: M = sqrt(maxima[0]) * sqrt(maxima[1]) + 1e-3, as the wgmma
    kernel forms it from the pre-pass's maxima."""
    return (maxima[0].sqrt() * maxima[1].sqrt() + 1e-3).reshape(1)


def logit_bound_plain(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The static logit bound of raw q: `logit_bound(prescale(q, scale), k)`
    by way of the pre-pass's two maxima."""
    return logit_bound_from_maxima(logit_bound_maxima_plain(q, k, scale))


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x f32 [B, L, N, D] -> (rint(x / s) s8, s [B, N, L] f32) with
    s = max|row| / 127 + 1e-8, f32 division and round half to even, as the
    TPU kernel's int8_qk branch (pallas_attention.py:160-166)."""
    amax = x.abs().amax(-1, keepdim=True)
    # a tensor divisor: PyTorch divides by a Python scalar on a card as a
    # multiply by its reciprocal, which is not the IEEE quotient
    s = amax / torch.full_like(amax, 127.0) + 1e-8
    return torch.round(x / s).to(torch.int8), s[..., 0].transpose(1, 2).contiguous()


def int8_qk_quantize_plain(q_scaled, k, seg: int):
    """The int8 mode's quanta: (q8, sq, k8, sk). q_scaled is the pre-scaled q
    (`prescale`); k is taken minus the mean of its `seg`-row segment
    (segments from row 0, the zero pad of the last one counted, the sum
    divided by seg), as the TPU kernel means each zero-padded bk sub-tile."""
    b, lk, n, d = k.shape
    nseg = -(-lk // seg)
    kf = k.float()
    kp = torch.cat([kf, kf.new_zeros((b, nseg * seg - lk, n, d))], 1)
    km = kp.reshape(b, nseg, seg, n, d).mean(dim=2)
    kc = kf - km.repeat_interleave(seg, dim=1)[:, :lk]
    q8, sq = _quantize_rows(q_scaled.float())
    k8, sk = _quantize_rows(kc)
    return q8, sq, k8, sk


def int8_qk_prepass_plain(q, k, seg: int, scale: float):
    """The int8 pre-pass on raw q: `int8_qk_quantize_plain(prescale(q, scale),
    k, seg)`, the quanta and scales the kernel's pre-pass forms (it prescales
    each q row to bf16(q * qscale(scale)) before its row max)."""
    return int8_qk_quantize_plain(prescale(q, scale), k, seg)


def int8_qk_attention_plain(q8, sq, k8, sk, v, valid, out_dtype,
                            heads_per_chunk: int = 4) -> torch.Tensor:
    """Masked softmax of float(s8 q8 @ k8^T) * (sq * sk) in the log2 domain,
    P cast to v's dtype before PV and the row sum applied after, as the
    kernels do. The s8 product is exact (float64). Heads go in chunks so the
    score tensor stays small at serving shapes."""
    outs = []
    for h0 in range(0, q8.shape[2], heads_per_chunk):
        hs = slice(h0, h0 + heads_per_chunk)
        s32 = torch.einsum("bqnd,bknd->bnqk", q8[:, :, hs].double(), k8[:, :, hs].double())
        s = s32.float() * (sq[:, hs, :, None] * sk[:, hs, None, :])
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v[:, :, hs].float())
        outs.append(o / p.sum(-1).transpose(1, 2)[..., None])
        del s32, s, p
    return torch.cat(outs, 2).to(out_dtype)


def window_attention_int8qk_plain(q, k, v, lo: int, hi: int, scale: Optional[float] = None,
                                  seg: Optional[int] = None) -> torch.Tensor:
    """K2-int8 in window mode; seg defaults to segment_rows(Lk)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        PLAIN_ON_CUDA["window"] += 1
    seg = seg or segment_rows(k.shape[1])
    quanta = int8_qk_prepass_plain(q, k, seg, scale)
    return int8_qk_attention_plain(*quanta, v, _window_mask(k.shape[1], lo, hi, q.device),
                                   q.dtype)


def block_causal_attention_int8qk_plain(q, k, v, block_tokens: int,
                                        local_window: Optional[int] = None,
                                        scale: Optional[float] = None,
                                        seg: Optional[int] = None) -> torch.Tensor:
    """K2-int8 in block-causal mode; seg defaults to segment_rows(Lk)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        PLAIN_ON_CUDA["block_causal"] += 1
    seg = seg or segment_rows(k.shape[1])
    quanta = int8_qk_prepass_plain(q, k, seg, scale)
    valid = block_causal_mask(q.shape[1], k.shape[1], block_tokens, k.shape[1],
                              local_window, q.device)
    return int8_qk_attention_plain(*quanta, v, valid, q.dtype)


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


def _launch_sm90(q, k, v, scale: float, maxima, mode, lo, hi, block_tokens, kv_len,
                 local_window, fault: int = 0, with_lse: bool = False):
    """One launch of the bf16 wgmma kernel on raw q. With `maxima` (the bound
    pre-pass's [2] f32) a window call takes the static max while M < 64.
    Returns out, or (out, lse [B, N, Lq] f32) with `with_lse`."""
    lib = _load()
    b, lq, n, d = q.shape
    out = torch.empty((b, lq, n, d), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=v.device) if with_lse else None
    with on_card(v):  # the .cu side acts on the current device
        err = lib.rtv_attention_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, k.shape[1], n, d,
            qscale(scale), None if maxima is None else maxima.data_ptr(),
            None if lse is None else lse.data_ptr(), mode, lo, hi, block_tokens, kv_len,
            local_window, fault, torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rtv_attention_sm90 launch failed: cudaError {err}")
    return (out, lse) if with_lse else out


def logit_bound_maxima(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """[2] f32 on q's device: the bound pre-pass's maxima (see
    `logit_bound_maxima_plain`), by the kernel for CUDA tensors."""
    if not q.is_cuda:
        return logit_bound_maxima_plain(q, k, scale)
    _check(q, k, k)
    return _maxima_launch(q, k, scale)


def _maxima_launch(q, k, scale: float) -> torch.Tensor:
    """The bound pre-pass on checked CUDA tensors (it zeroes its output)."""
    lib = _load()
    maxima = torch.empty(2, dtype=torch.float32, device=q.device)
    with on_card(q):
        err = lib.rtv_logit_bound(q.data_ptr(), k.data_ptr(), maxima.data_ptr(),
                                  q.numel() // q.shape[-1], k.numel() // k.shape[-1],
                                  q.shape[-1], qscale(scale),
                                  torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rtv_logit_bound launch failed: cudaError {err}")
    PREPASS_LAUNCHES["logit_bound"] += 1
    return maxima


def _quantize_launch(q, k, seg: int, scale: float):
    """The int8 pre-pass on the card, on raw q: (q8, sq, k8, sk) as
    int8_qk_prepass_plain. sk is the [B, N, Lk] view of rows padded to a
    multiple of 4 (TMA's 16-byte row pitch)."""
    lib = _load()
    b, lq, n, d = q.shape
    lk = k.shape[1]
    dev = q.device
    q8 = torch.empty((b, lq, n, d), dtype=torch.int8, device=dev)
    k8 = torch.empty((b, lk, n, d), dtype=torch.int8, device=dev)
    sq = torch.empty((b, n, lq), dtype=torch.float32, device=dev)
    sk = torch.empty((b, n, _round_up(lk, 4)), dtype=torch.float32, device=dev)
    km = torch.empty((b, -(-lk // seg), n, d), dtype=torch.float32, device=dev)
    with on_card(q):
        err = lib.rtv_int8_qk_quantize(
            q.data_ptr(), k.data_ptr(), q8.data_ptr(), sq.data_ptr(), k8.data_ptr(),
            sk.data_ptr(), km.data_ptr(), b, lq, lk, n, d, seg, qscale(scale), sk.shape[-1],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rtv_int8_qk_quantize launch failed: cudaError {err}")
    return q8, sq, k8, sk[..., :lk]


def int8_qk_prepass(q, k, seg: int, scale: float):
    """(q8, sq, k8, sk) of raw q and k: the pre-pass kernel for CUDA tensors
    (`int8_qk_prepass_plain` on the CPU)."""
    if not q.is_cuda:
        return int8_qk_prepass_plain(q, k, seg, scale)
    _check(q, k, k)
    return _quantize_launch(q, k, seg, scale)


def _launch_int8(q, k, v, scale: float, mode, lo, hi, block_tokens, kv_len, local_window,
                 seg: int, fault: int = 0) -> torch.Tensor:
    """The int8 mode on raw q: the pre-pass, then the wgmma kernel on its
    quanta."""
    q8, sq, k8, sk = _quantize_launch(q, k, seg, scale)
    lib = _load()
    b, lq, n, d = q.shape
    out = torch.empty((b, lq, n, d), dtype=v.dtype, device=v.device)
    with on_card(v):
        err = lib.rtv_attention_sm90_int8(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(), sq.data_ptr(),
            sk.data_ptr(), sk.stride(1), b, lq, k.shape[1], n, d, mode, lo, hi, block_tokens,
            kv_len, local_window, seg, fault, torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rtv_attention_sm90_int8 launch failed: cudaError {err}")
    return out


def attention_backward(q, k, v, o, do, lse, scale: float, mask: Mask, need_kv: bool = True,
                       fault: int = 0):
    """(dq, dk, dv) of attention under `mask`: the backward kernel for CUDA
    tensors (dk and dv None when not `need_kv`: only the dQ pass runs),
    `attention_backward_plain` on the CPU. The kernel differentiates the
    function the forward kernel computes, whose scores are bf16(q * c) k^T
    with c = qscale(scale) (see `kernel_backward_plain`), against the lse
    that forward wrote."""
    if not q.is_cuda:
        return attention_backward_plain(q, k, v, o, do, lse, scale, mask)
    _check(q, k, v)
    _check(o, do, do)
    if o.shape != q.shape or lse.shape != (q.shape[0], q.shape[2], q.shape[1]) \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"o {tuple(o.shape)} / lse {tuple(lse.shape)} {lse.dtype} do not "
                         f"match q {tuple(q.shape)}")
    lib = _load_bwd()
    b, lq, n, d = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k) if need_kv else None
    dv = torch.empty_like(v) if need_kv else None
    # per row lse * log2 e and D = rowsum(dO * o), rows padded to 16 bytes for TMA
    stats = torch.empty((b, n, 2, _round_up(lq, 4)), dtype=torch.float32, device=q.device)
    qc = torch.empty_like(q)
    with on_card(q):
        err = lib.rtv_attention_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), stats.data_ptr(), qc.data_ptr(), dq.data_ptr(),
            None if dk is None else dk.data_ptr(), None if dv is None else dv.data_ptr(), b,
            lq, k.shape[1], n, d, qscale(scale), *mask.kernel_args(), int(need_kv), fault,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rtv_attention_bwd_sm90 launch failed: cudaError {err}")
    LAUNCHES[f"{mask.key}_bwd"] += 1
    return dq, dk, dv


class KernelAttention(torch.autograd.Function):
    """Attention under a `Mask` with its gradient. On a CUDA tensor the
    forward is the bf16 kernel writing the row LSE (the window with the
    static max when `static`, after the bound pre-pass; block-causal with the
    running max), counted under the route as any call, and the backward is
    the backward kernel; on the CPU both are the plain versions, so CPU
    autograd equals the dense softmax's."""

    @staticmethod
    def forward(ctx, q, k, v, mask: Mask, scale: float, static: bool, bound_group=None):
        if q.is_cuda:
            _check(q, k, v)
            maxima = _bound_maxima(q, k, scale, bound_group) if static else None
            out, lse = _launch_sm90(q, k, v, scale, maxima, *mask.kernel_args(), with_lse=True)
            LAUNCHES[mask.key] += 1
        else:
            out, lse = attention_forward_plain(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.scale = mask, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = attention_backward(q, k, v, out, do.contiguous(), lse, ctx.scale, ctx.mask,
                                        need_kv=need_kv)
        return dq, dk, dv, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _bound_maxima(q, k, scale: float, bound_group=None) -> torch.Tensor:
    """The bound pre-pass's maxima, MAX-reduced over `bound_group` when one
    is given: a rank that holds some of the heads (tp, Ulysses) then takes
    the bound of all of them, as one device would."""
    maxima = _maxima_launch(q, k, scale)
    if bound_group is not None:
        coll.all_reduce_max_(maxima, bound_group)
    return maxima


def window_attention(q, k, v, lo: int, hi: int, scale: Optional[float] = None,
                     route: Optional[str] = None, bound_group=None,
                     return_lse: bool = False):
    """Attend q to KV positions [lo, hi) (host ints), by `route` (one of
    WINDOW_ROUTES; default: `window_route()` under the current switches).
    `bound_group`: MAX-reduce the static logit bound over this process group
    before the launch (`_bound_maxima`). `return_lse` (the unmasked bf16
    window only, no gradient): (out, lse), lse the natural-log f32 [B, N,
    Lq] of the function the launch computed (the kernel's, whose scores are
    bf16(q c) k^T; the plain forward's on the CPU)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lk = k.shape[1]
    lo, hi = max(int(lo), 0), min(int(hi), lk)
    route = route or window_route()
    if route not in WINDOW_ROUTES:
        raise ValueError(f"window route {route!r} not in {WINDOW_ROUTES}")
    int8 = route == "window_int8qk"
    if return_lse:
        if route != "window" or (lo, hi) != (0, lk) or _needs_grad(q, k, v):
            raise ValueError("return_lse is the unmasked 'window' route's, without a gradient")
        if not q.is_cuda:
            return attention_forward_plain(q, k, v, Mask.window(lo, hi), scale)
        _check(q, k, v)
        maxima = _bound_maxima(q, k, scale, bound_group) if static_max(route) else None
        out = _launch_sm90(q, k, v, scale, maxima, _MODE_WINDOW, lo, hi, 1, lk, -1,
                           with_lse=True)
        LAUNCHES[route] += 1
        return out
    if _needs_grad(q, k, v):
        if route != "window":
            raise NotImplementedError(
                f"the {route!r} attention route has no backward kernel: a gradient needs the "
                "bf16 'window' route (RTV_ATTN_INT8, _SKEW and _SKEW2 off)")
        return KernelAttention.apply(q, k, v, Mask.window(lo, hi), scale, static_max(route),
                                     bound_group)
    if not q.is_cuda:
        if int8:
            return window_attention_int8qk_plain(q, k, v, lo, hi, scale)
        return window_attention_plain(q, k, v, lo, hi, scale)
    _check(q, k, v)
    if int8:
        out = _launch_int8(q, k, v, scale, _MODE_WINDOW, lo, hi, 1, lk, -1,
                           seg=segment_rows(lk))
    else:  # window (K1/K2), window_skew (K6a), window_skew_staticmax (K6b)
        maxima = _bound_maxima(q, k, scale, bound_group) if static_max(route) else None
        out = _launch_sm90(q, k, v, scale, maxima, _MODE_WINDOW, lo, hi, 1, lk, -1)
    LAUNCHES[route] += 1
    return out


def block_causal_attention(q, k, v, block_tokens: int,
                           local_window: Optional[int] = None,
                           scale: Optional[float] = None,
                           route: Optional[str] = None) -> torch.Tensor:
    """Blockwise-causal self attention (K2 block-causal mode; int8 QK^T on the
    `block_causal_int8qk` route, the default under INT8_QK)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if block_tokens <= 0:
        raise ValueError(f"block_tokens must be positive, got {block_tokens}")
    route = route or block_causal_route()
    if route not in BLOCK_CAUSAL_ROUTES:
        raise ValueError(f"block-causal route {route!r} not in {BLOCK_CAUSAL_ROUTES}")
    int8 = route == "block_causal_int8qk"
    if _needs_grad(q, k, v):
        if route != "block_causal":
            raise NotImplementedError(
                f"the {route!r} attention route has no backward kernel: a gradient needs the "
                "bf16 'block_causal' route (RTV_ATTN_INT8 off)")
        if q.shape[1] != k.shape[1]:
            raise ValueError("block-causal attention needs Lq == Lk")
        return KernelAttention.apply(q, k, v, Mask.block_causal(k.shape[1], block_tokens,
                                                                local_window), scale, False,
                                     None)
    if not q.is_cuda:
        if int8:
            return block_causal_attention_int8qk_plain(q, k, v, block_tokens, local_window,
                                                       scale)
        return block_causal_attention_plain(q, k, v, block_tokens, local_window, scale)
    _check(q, k, v)
    if q.shape[1] != k.shape[1]:
        raise ValueError("block-causal attention needs Lq == Lk")
    if local_window is not None and local_window <= 0:
        raise ValueError(f"local_window must be positive, got {local_window}")
    lk = k.shape[1]
    args = (_MODE_BLOCK_CAUSAL, 0, lk, int(block_tokens), lk,
            -1 if local_window is None else int(local_window))
    if int8:
        out = _launch_int8(q, k, v, scale, *args, seg=segment_rows(lk))
    else:
        out = _launch_sm90(q, k, v, scale, None, *args)
    LAUNCHES[route] += 1
    return out


def teacher_forcing_attention_plain(q, k, v, half_len: int, block_tokens: int,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of the teacher-forcing route: the dense mask through
    the masked f32 softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        PLAIN_ON_CUDA["teacher_forcing"] += 1
    valid = Mask.teacher_forcing(half_len, block_tokens).dense(q.shape[1], k.shape[1], q.device)
    return _masked_softmax_attention(q, k, v, valid, scale)


def teacher_forcing_attention(q, k, v, half_len: int, block_tokens: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over [clean | noisy] (Lq = Lk = 2 * half_len) under the
    teacher-forcing mask (`teacher_forcing_dense`): on a CUDA tensor mode 2 of
    the bf16 kernel, through `KernelAttention` (the backward kernel's mode 2)
    when a gradient is needed; on the CPU the plain version. Always bf16: the
    JAX package runs this mask through dense XLA whatever RTV_ATTN_INT8 says,
    so the int8 and skew switches do not apply here."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = Mask.teacher_forcing(half_len, block_tokens)
    if q.shape[1] != mask.hi or k.shape[1] != mask.hi:
        raise ValueError(f"teacher forcing over 2 x {half_len} tokens, got Lq {q.shape[1]} "
                         f"and Lk {k.shape[1]}")
    if _needs_grad(q, k, v):
        return KernelAttention.apply(q, k, v, mask, scale, False, None)
    if not q.is_cuda:
        return teacher_forcing_attention_plain(q, k, v, half_len, block_tokens, scale)
    _check(q, k, v)
    out = _launch_sm90(q, k, v, scale, None, *mask.kernel_args())
    LAUNCHES["teacher_forcing"] += 1
    return out


def teacher_forcing_pairs(half_len: int, block_tokens: int) -> int:
    """Live (query, key) pairs of one head under the teacher-forcing mask:
    each half holds the block triangle, sum over blocks j of B * (j + 1) B."""
    n = half_len // block_tokens
    return block_tokens ** 2 * n * (n + 1)


def window_flops(lq: int, lo: int, hi: int, heads: int, head_dim: int,
                 batch: int = 1) -> float:
    """FLOP of QK^T and PV over the live columns [lo, hi) of a window call
    (half of it QK^T, half PV)."""
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


def grad_atol(want: torch.Tensor) -> float:
    """Elementwise bound of the backward kernel against its plain version:
    the kernel rounds P and dS to bf16 before its products, which moves a
    sum by up to 2^-9 of the sum of its terms' magnitudes, and rounds its
    outputs to bf16; a gradient element that cancels is small against its
    terms, so the bound is 2^-7 of the tensor's largest element. The
    relative Frobenius bound REL_FRO holds as for the forward."""
    return 2.0 ** -7 * want.float().abs().max().item()


#: dq where keys are near-parallel (the decode window with k = [q; 0.97 q] at
#: large norm: chip_smoke.py's and the CUDA test's near-parallel cases). A
#: row's two top keys' dS nearly cancel in dQ = sum dS k; O is stored in
#: bf16, so their magnitudes differ by a fraction of an ulp, and rounding dS
#: to bf16 for the dQ product, as the kernel and torch SDPA's flash backward
#: both do, moves dq by 5-7% there
#: (tests/test_torch_attention_bwd_precision.py). The bars for dq in those
#: cases: relative Frobenius NEAR_PARALLEL_DQ_REL_FRO and elementwise
#: NEAR_PARALLEL_DQ_ATOL times the largest |dq|, each about 1.5x the error
#: of SDPA flash's backward at the same input on the card (7.4e-2 and 6.0e-2
#: relative Frobenius, 0.142 and 0.144 of the largest |dq|, at norm 1.5 and
#: 3.0; H100 80GB HBM3, 700 W; the kernel: 7.5e-2 and 6.0e-2); dk and dv
#: keep the unit bars.
NEAR_PARALLEL_DQ_REL_FRO, NEAR_PARALLEL_DQ_ATOL = 0.11, 0.22


def near_parallel_dq_agreement(got: torch.Tensor, want: torch.Tensor) -> Dict[str, object]:
    """`agreement` of dq at the near-parallel bars."""
    return agreement(got, want, NEAR_PARALLEL_DQ_ATOL * want.float().abs().max().item(),
                     NEAR_PARALLEL_DQ_REL_FRO)


def agreement(got: torch.Tensor, want: torch.Tensor,
              atol: float = ATOL, rel_fro_bar: float = REL_FRO) -> Dict[str, object]:
    """Compare a kernel output with its plain version under the bounds above."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rel_fro = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    elementwise = bool((diff <= atol + RTOL * want.abs()).all())
    return {"max_abs_err": diff.max().item(), "rel_fro_err": rel_fro, "atol": atol,
            "within_tol": bool(torch.isfinite(got).all()) and elementwise
            and rel_fro <= rel_fro_bar}


def quanta_agreement(got, want) -> Dict[str, object]:
    """Share of s8 quanta (q8 and k8 together) that differ between the
    pre-pass kernel and the plain version, and the largest difference. Only
    the summation order of the segment means may differ, so a quantum may
    move by 1 in rare elements: the bar is a share <= 1e-3, off by <= 1."""
    n_diff, n_all, worst = 0, 0, 0
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        d = (g.int() - w.int()).abs()
        n_diff += int((d > 0).sum())
        n_all += d.numel()
        worst = max(worst, int(d.max()))
    share = n_diff / n_all
    return {"quanta_differing_share": share, "quanta_max_diff": worst,
            "within_tol": share <= 1e-3 and worst <= 1}
