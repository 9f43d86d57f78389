"""KV-cache state for the block-causal DiT (port of realtime_video_tpu/ops/kv_cache.py).

    kv = {
      "k": [L, B, S, N, Dh],  "v": [L, B, S, N, Dh],   preallocated tensors
      "global_end": int,      "local_end": int,        host-side indices
    }

The JAX package threads the cache functionally through a jitted scan with
donated buffers; here the buffers are written in place by slice assignment
and the end indices are Python ints computed on the host, so planning a write
never waits on the device. Eviction semantics mirror causal_model.py:358-392.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def init_kv_cache(num_layers: int, batch_size: int, cache_size: int, num_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device=None) -> Dict:
    """Zeroed cache (reference _initialize_kv_cache, causal_inference.py:279-314)."""
    shape = (num_layers, batch_size, cache_size, num_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "global_end": 0,
        "local_end": 0,
    }


def reset_kv_cache(kv: Dict) -> Dict:
    """Zero the cache in place and rewind its ends (causal_inference.py:296-302)."""
    kv["k"].zero_()
    kv["v"].zero_()
    kv["global_end"] = 0
    kv["local_end"] = 0
    return kv


def init_crossattn_cache(num_layers: int, batch_size: int, text_len: int,
                         num_heads: int, head_dim: int, dtype=torch.bfloat16,
                         device=None) -> Dict:
    """Cross-attention K/V cache over the text tokens (causal_inference.py:316-339)."""
    shape = (num_layers, batch_size, text_len, num_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def plan_kv_update(kv: Dict, current_start: int, num_new: int, cache_size: int,
                   sink_tokens: int, rolling: bool) -> Tuple[int, int, int, int]:
    """(shift, write_start, new_global_end, new_local_end), all host ints.

    `shift` is the left shift of the non-sink region before the write (0
    unless rolling eviction triggers). The evicted amount is num_new +
    local_end - cache_size, from the full write length and not the net
    appended amount (causal_model.py:363-368)."""
    del sink_tokens  # only where the shift applies (shift_layer_cache), not how much
    current_end = current_start + num_new
    appended = current_end - kv["global_end"]  # 0 on re-denoise of the same block
    shift = 0
    if rolling and current_end > kv["global_end"] and num_new + kv["local_end"] > cache_size:
        shift = num_new + kv["local_end"] - cache_size
    new_local_end = kv["local_end"] + appended - shift
    write_start = new_local_end - num_new
    return shift, write_start, current_end, new_local_end


def shift_layer_cache(buf: torch.Tensor, shift: int, sink_tokens: int) -> torch.Tensor:
    """Shift [B, S, N, D] left by `shift` beyond the sink region (a gather).

    Positions that shift past the end keep stale values — they are
    overwritten or masked out right after (causal_model.py:368-373)."""
    S = buf.shape[1]
    idx = torch.arange(S, device=buf.device)
    src = torch.where(idx >= sink_tokens, torch.clamp(idx + shift, max=S - 1), idx)
    return buf.index_select(1, src)
