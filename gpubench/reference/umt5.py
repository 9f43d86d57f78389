"""Plain float32 umT5 encoder (Wan's t5.py: no q scaling, per-layer
log-bucketed relative position biases, gated-GELU feed-forward, pre-norm
RMS layers, padding positions zeroed), over weights drawn a layer at a time
from `gpubench.weights`, and the hash tokenizer used where no tokenizer
files exist: each whitespace-separated word's id is CRC-32 of its UTF-8
bytes mod (vocab - 256), plus 256; then the end token 1, then 0 padding.
"""
from __future__ import annotations

import html
import math
import re
import zlib
from typing import Tuple

import numpy as np
import torch

from gpubench import weights


def tokenize(text: str, seq_len: int, vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [seq_len] int64, mask [seq_len] int64) of one prompt."""
    text = re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip()
    toks = [zlib.crc32(w.encode("utf-8")) % (vocab_size - 256) + 256
            for w in text.split(" ") if w][: seq_len - 1] + [1]
    ids = torch.zeros(seq_len, dtype=torch.long)
    mask = torch.zeros(seq_len, dtype=torch.long)
    ids[: len(toks)] = torch.tensor(toks)
    mask[: len(toks)] = 1
    return ids, mask


def buckets(length: int, num_buckets: int, max_dist: int) -> np.ndarray:
    """[L, L] bidirectional relative-position bucket ids."""
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(rel, 1) / exact) / math.log(max_dist / exact)
                     * (nb - exact)).astype(np.int64)
    return out + np.where(rel < exact, rel, np.minimum(large, nb - 1))


def norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def encode(cfg: dict, seed: int, ids: torch.Tensor, mask: torch.Tensor, device) -> torch.Tensor:
    """ids, mask [L] -> the prompt embedding [1, L, dim] f32, padding zeroed."""
    device = torch.device(device)
    ids, mask = ids.to(device), mask.to(device)
    d, nh = cfg["dim"], cfg["num_heads"]
    hd = cfg["dim_attn"] // nh
    L = ids.shape[0]
    x = torch.empty((L, d), device=device)
    slab_of = ids // weights.EMBED_ROWS
    for s in torch.unique(slab_of).tolist():
        rows = weights.t5_embedding_rows(cfg, seed, s, device)
        sel = slab_of == s
        x[sel] = rows[ids[sel] - s * weights.EMBED_ROWS].float()
        del rows
    bucket = torch.from_numpy(buckets(L, cfg["num_buckets"], cfg["max_dist"])).to(device)
    key_mask = torch.where(mask > 0, 0.0, float("-inf"))[None, None, :]
    for i in range(cfg["num_layers"]):
        w = {k: v.float() for k, v in weights.t5_layer(cfg, seed, i, device).items()}
        y = norm(x, w[("norm1", "scale")])
        q, k, v = (
            (y @ w[("attn", n, "w")]).reshape(L, nh, hd).transpose(0, 1) for n in "qkv")
        logits = q @ k.transpose(-1, -2) + w[("rel_emb",)][bucket].permute(2, 0, 1) + key_mask
        o = (torch.softmax(logits, -1) @ v).transpose(0, 1).reshape(L, -1)
        x = x + o @ w[("attn", "o", "w")]
        y = norm(x, w[("norm2", "scale")])
        gate = torch.nn.functional.gelu(y @ w[("ffn", "gate", "w")], approximate="tanh")
        x = x + ((y @ w[("ffn", "fc1", "w")]) * gate) @ w[("ffn", "fc2", "w")]
    x = norm(x, weights.t5_norm(cfg, seed, device).float())
    return (x * (mask[:, None] > 0))[None]
