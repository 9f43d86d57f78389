"""KV-cache state for the block-causal DiT (port of realtime_video_tpu/ops/kv_cache.py).

    kv = {
      "k": [L, B, S, N, Dh],  "v": [L, B, S, N, Dh],   preallocated tensors
      "global_end": int,      "local_end": int,        host-side indices
    }

The JAX package threads the cache functionally through a jitted scan with
donated buffers; here the buffers are written in place by slice assignment
and the end indices are Python ints computed on the host, so planning a write
never waits on the device. Eviction semantics mirror causal_model.py:358-392.

Training needs the gradient through the cached K/V (the JAX rollout's cache
refresh carries the parameter gradient into the next block), which in-place
writes into one buffer cannot give: each denoise step overwrites the rows a
saved tensor aliases, and every layer's write would chain through the one
[L, B, S, N, Dh] buffer. The training cache (`init_train_kv_cache`) keeps,
per layer, the K/V tensors each write made, keyed by their start:

    kv = {"blocks": [[(start, k [B, n, N, Dh], v), ...] per layer],
          "cache_size": int, "global_end": int, "local_end": int}

A write at `start` replaces the entries at or after it (a re-denoise of the
same block overwrites, as the buffer's rows are), and the attention window
is the concatenation of the last min(max_attention_size, cache_size)
tokens, the JAX package's window and eviction when blocks tile the cache.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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


def init_train_kv_cache(num_layers: int, cache_size: int) -> Dict:
    """An empty training cache of `cache_size` tokens (see the module note)."""
    return {"blocks": [[] for _ in range(num_layers)], "cache_size": int(cache_size),
            "global_end": 0, "local_end": 0}


def is_train_cache(kv: Dict) -> bool:
    return "blocks" in kv


def cache_size(kv: Dict) -> int:
    """Tokens the cache holds at most."""
    return kv["cache_size"] if is_train_cache(kv) else kv["k"].shape[2]


def _entries_before(kv: Dict, lid: int, start: int) -> list:
    """Layer `lid`'s entries before `start`, which must end exactly there."""
    entries = [e for e in kv["blocks"][lid] if e[0] < start]
    end = entries[-1][0] + entries[-1][1].shape[1] if entries else 0
    if end != start:
        raise ValueError(f"training cache: a write at {start} after K/V that end at {end}")
    return entries


def train_cache_prefix(kv: Dict, lid: int, start: int,
                       keep: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The cached K and V of layer `lid` for the `keep` positions before
    `start`, as lists of tensors in position order (views of the entries)."""
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    need = keep
    for _, k, v in reversed(_entries_before(kv, lid, start)):
        if need <= 0:
            break
        if k.shape[1] > need:
            k, v = k[:, k.shape[1] - need:], v[:, v.shape[1] - need:]
        ks.insert(0, k)
        vs.insert(0, v)
        need -= k.shape[1]
    return ks, vs


def train_cache_write(kv: Dict, lid: int, start: int, k: torch.Tensor, v: torch.Tensor,
                      window: int) -> None:
    """Record layer `lid`'s K/V of positions [start, start + n), dropping the
    entries at or after `start` and those wholly before the last `window`
    positions."""
    entries = _entries_before(kv, lid, start) + [(start, k, v)]
    end = start + k.shape[1]
    kv["blocks"][lid] = [e for e in entries if e[0] + e[1].shape[1] > end - window]
