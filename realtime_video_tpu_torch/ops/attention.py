"""Attention dispatcher and attention masks (port of realtime_video_tpu/ops/attention.py).

q [B, Lq, N, D], k/v [B, Lk, N, D]. Every entry point sends a CUDA tensor to
the hand-written Hopper kernel (`ops/hopper_attention.py`, `csrc/attention_sm90.cu`)
and a CPU tensor to the plain PyTorch version beside that kernel. There is no
library attention on either side and no fallback from the kernel: a call the
kernel cannot take raises.

  * `attention(q, k, v)` — unmasked (cross-attention over the text tokens);
    with a dense `mask` only the plain version exists, so it runs on the CPU
    alone.
  * `decode_attention(q, k, v, lo, hi)` — the rolling-cache window [lo, hi).
  * `attention_with_lse(q, k, v)` — unmasked, with each row's LSE (the
    sequence-parallel ring merges these).
  * `block_causal_attention(q, k, v, block_tokens, local_window)` —
    kv < ends[q] (get_block_mask semantics, causal_model.py:108-141).
  * `teacher_forcing_attention(q, k, v, half_len, block_tokens)` — the
    [clean | noisy] mask of `teacher_forcing_mask` as structure (the kernel's
    mode 2), always bf16 on the card.

Which mode of the kernel a call takes follows the JAX package's attention
switches (RTV_ATTN_INT8, _SKEW, _SKEW2, _STATICMAX, _BK), which
`hopper_attention` reads into module attributes: the unmasked entry and the
decode window share `hopper_attention.window_route`, as `flash_attention`
and `decode_attention` share one path there.
"""
from __future__ import annotations

from typing import Optional

import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk

NEG_INF = hk.NEG_INF


def plain_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked softmax attention in f32 (the `xla_attention` analog).
    mask: bool, broadcastable to [B, N, Lq, Lk], True = attend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    valid = torch.ones((), dtype=torch.bool, device=q.device) if mask is None else mask
    return hk._masked_softmax_attention(q, k, v, valid, scale)


def attention(q, k, v, mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None, bound_group=None) -> torch.Tensor:
    """`bound_group`: the tp (or Ulysses) group over whose ranks the static
    logit bound is MAX-reduced (`hopper_attention.window_attention`)."""
    if mask is None:
        return hk.window_attention(q, k, v, 0, k.shape[1], scale, bound_group=bound_group)
    if q.is_cuda:
        raise NotImplementedError(
            "dense-mask attention has no CUDA kernel in the port; use "
            "decode_attention or block_causal_attention")
    return plain_attention(q, k, v, mask, scale)


def decode_attention(q, k, v, lo: int, hi: int, bound_group=None) -> torch.Tensor:
    """Cache-window decode attention: q attends to k/v positions [lo, hi)."""
    return hk.window_attention(q, k, v, lo, hi, bound_group=bound_group)


def attention_with_lse(q, k, v, scale: Optional[float] = None):
    """Unmasked attention and each row's natural-log LSE (f32 [B, N, Lq]) of
    the function the launch computed: one K1 launch on a card, the plain
    forward on the CPU (a ring step of `parallel/sequence.py`)."""
    return hk.window_attention(q, k, v, 0, k.shape[1], scale, route="window", return_lse=True)


def block_causal_attention(q, k, v, block_tokens: int,
                           local_window: Optional[int] = None) -> torch.Tensor:
    return hk.block_causal_attention(q, k, v, block_tokens, local_window)


def teacher_forcing_attention(q, k, v, half_len: int, block_tokens: int) -> torch.Tensor:
    return hk.teacher_forcing_attention(q, k, v, half_len, block_tokens)


# ---------------------------------------------------------------------------
# attention masks
# ---------------------------------------------------------------------------


def frame_block_ends(num_tokens: int, frame_seqlen: int, num_frame_per_block: int,
                     device=None) -> torch.Tensor:
    """ends[i] = end token index (exclusive) of the block containing token i."""
    idx = torch.arange(num_tokens, device=device)
    block = frame_seqlen * num_frame_per_block
    return (idx // block + 1) * block


def blockwise_causal_mask(num_frames: int, frame_seqlen: int, num_frame_per_block: int,
                          local_attn_size: int = -1,
                          independent_first_frame: bool = False,
                          device=None) -> torch.Tensor:
    """[L, L] bool mask: kv < ends[q] | q == kv (+ local window)."""
    n = num_frames * frame_seqlen
    q_idx = torch.arange(n, device=device)[:, None]
    kv_idx = torch.arange(n, device=device)[None, :]
    block = frame_seqlen * num_frame_per_block
    if independent_first_frame:
        shifted = torch.clamp(q_idx - frame_seqlen, min=0)
        ends = torch.where(q_idx < frame_seqlen, torch.full_like(q_idx, frame_seqlen),
                           frame_seqlen + (shifted // block + 1) * block)
    else:
        ends = (q_idx // block + 1) * block
    mask = kv_idx < ends
    if local_attn_size != -1:
        mask = mask & (kv_idx >= ends - local_attn_size * frame_seqlen)
    return mask | (q_idx == kv_idx)


def teacher_forcing_mask(num_frames: int, frame_seqlen: int, num_frame_per_block: int,
                         device=None) -> torch.Tensor:
    """[2L, 2L] bool mask for teacher-forcing training over the sequence
    [clean | noisy] (L = num_frames * frame_seqlen): clean tokens are
    blockwise-causal over the clean half; noisy tokens see their own noisy
    block and the clean tokens of strictly earlier blocks; and the diagonal
    (_prepare_teacher_forcing_mask, causal_model.py:676-762)."""
    return hk.teacher_forcing_dense(num_frames * frame_seqlen,
                                    frame_seqlen * num_frame_per_block, device)


def decode_window_mask(num_q: int, num_kv: int, kv_abs_start: int, local_end: int,
                       max_attention_size: int, device=None) -> torch.Tensor:
    """[1, 1, 1, num_kv] bool mask (broadcast over the num_q queries) for
    cache-window decode attention over a KV slice holding positions
    [kv_abs_start, kv_abs_start + num_kv)."""
    del num_q
    kv_pos = torch.arange(num_kv, device=device)[None, :] + kv_abs_start
    lo = max(local_end - max_attention_size, 0)
    valid = (kv_pos >= lo) & (kv_pos < local_end)
    return valid[None, None]
