"""umT5-XXL text encoder in PyTorch (port of realtime_video_tpu/models/t5.py,
after the reference's from-scratch T5, wan/modules/t5.py):
  * T5Attention without q scaling (t5.py:111-114);
  * per-layer relative position embeddings (umT5: shared_pos=False,
    t5.py:466-467) with the standard log-bucketed relative positions
    (t5.py:245-264);
  * gated-GELU feed-forward fc1(x) * gelu(gate(x)) (t5.py:123-141);
  * pre-norm residual blocks, final T5LayerNorm.

Parameters keep the JAX package's layout: the blocks stacked on a leading
layer axis, linear weights [in, out], `rel_emb` [num_buckets, heads] in f32,
so a JAX tree carries across leaf by leaf (`utils/convert.t5_params_from_jax`).
The forward is a Python loop over layers of plain torch ops, as the JAX
package computes it outside Pallas: the attention logits in f32 (bf16 q·k
products are exact in f32) with the f32 position bias and the -1e30 key mask
added there, the softmax in f32, then bf16 again for the value product.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from realtime_video_tpu_torch.config import T5Config

Params = Dict[str, Any]

#: rows of the token embedding drawn at a time (the f32 draw of umT5's whole
#: 256384 x 4096 table would take 4.2 GB)
_EMBED_ROWS = 16384


def t5_layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS-style norm without mean subtraction (t5.py:53-66), in f32."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (p["scale"].float() * y).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # explicit tanh-GELU (t5.py:46-50)
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32, max_dist: int = 128,
                              bidirectional: bool = True, device=None) -> torch.Tensor:
    """[lq, lk] int64 bucket ids (t5.py:245-264), computed in numpy as the JAX
    package does."""
    ctx = np.arange(lk)[None, :] - np.arange(lq)[:, None]  # rel_pos
    if bidirectional:
        nb = num_buckets // 2
        buckets = (ctx > 0).astype(np.int64) * nb
        rel = np.abs(ctx)
    else:
        nb = num_buckets
        buckets = np.zeros_like(ctx)
        rel = -np.minimum(ctx, 0)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / math.log(max_dist / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets = buckets + np.where(rel < max_exact, rel, large)
    return torch.from_numpy(buckets.astype(np.int64)).to(device)


def init_t5_encoder_params(cfg: T5Config, generator: torch.Generator, device=None,
                           dtype=torch.bfloat16) -> Params:
    """Random init with the distributions of the JAX package's
    init_t5_encoder_params (t5.py:64-105; only shapes matter, real use loads
    weights), drawn from `generator` on `device`: each layer's matrix in f32,
    then cast into its slot of the stacked tensor, so the f32 temporaries stay
    one layer's (or one slab of the embedding's) size."""
    d, da, dff, nh, nl = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads, cfg.num_layers
    g = generator

    def normal(shape, std, out_dtype):
        return (torch.randn(shape, generator=g, dtype=torch.float32, device=device)
                * std).to(out_dtype)

    def stacked(din, dout, std):
        w = torch.empty((nl, din, dout), dtype=dtype, device=device)
        for i in range(nl):
            w[i] = normal((din, dout), std, dtype)
        return {"w": w}

    def ones():
        return {"scale": torch.ones((nl, d), dtype=dtype, device=device)}

    blocks = {
        "norm1": ones(),
        "attn": {
            "q": stacked(d, da, (d * da) ** -0.5),
            "k": stacked(d, da, d ** -0.5),
            "v": stacked(d, da, d ** -0.5),
            "o": stacked(da, d, (nh * (da // nh)) ** -0.5),
        },
        "norm2": ones(),
        "ffn": {
            "gate": stacked(d, dff, d ** -0.5),
            "fc1": stacked(d, dff, d ** -0.5),
            "fc2": stacked(dff, d, dff ** -0.5),
        },
        "rel_emb": normal((nl, cfg.num_buckets, nh), (2 * cfg.num_buckets * nh) ** -0.5,
                          torch.float32),
    }
    emb = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    for r in range(0, cfg.vocab_size, _EMBED_ROWS):
        rows = min(_EMBED_ROWS, cfg.vocab_size - r)
        emb[r:r + rows] = normal((rows, d), 1.0, dtype)
    return {"token_embedding": emb, "blocks": blocks,
            "norm": {"scale": torch.ones((d,), dtype=dtype, device=device)}}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def t5_encode(cfg: T5Config, params: Params, ids: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids [B, L] (1 = token in mask) -> [B, L, dim] final hidden states
    (t5.py:303-312), in the parameters' dtype."""
    b, L = ids.shape
    nh = cfg.num_heads
    hd = cfg.dim_attn // nh
    emb = params["token_embedding"]
    dev = emb.device
    ids = ids.to(dev)
    x = emb[ids]
    buckets = relative_position_buckets(L, L, cfg.num_buckets, cfg.max_dist,
                                        bidirectional=True, device=dev)
    if mask is not None:
        # added in f32: -1e30 overflows bf16
        attn_mask = torch.where(mask.to(dev)[:, None, None, :] > 0, 0.0, -1e30).to(
            torch.float32)
    else:
        attn_mask = torch.zeros((b, 1, 1, L), dtype=torch.float32, device=dev)

    def heads(t):  # [B, L, H*hd] -> [B, H, L, hd]
        return t.reshape(b, L, nh, hd).transpose(1, 2)

    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        # self attention (no q scaling)
        y = t5_layer_norm(bp["norm1"], x)
        ap = bp["attn"]
        q = heads(y @ ap["q"]["w"].to(y.dtype))
        k = heads(y @ ap["k"]["w"].to(y.dtype))
        v = heads(y @ ap["v"]["w"].to(y.dtype))
        pos_bias = bp["rel_emb"].float()[buckets].permute(2, 0, 1)[None]  # [1, H, L, L]
        logits = q.float() @ k.float().transpose(-1, -2) + pos_bias + attn_mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = (probs @ v).transpose(1, 2).reshape(b, L, cfg.dim_attn)
        x = x + o @ ap["o"]["w"].to(o.dtype)
        # gated-GELU ffn
        y = t5_layer_norm(bp["norm2"], x)
        fp = bp["ffn"]
        gate = y @ fp["gate"]["w"].to(y.dtype)
        h = ((y @ fp["fc1"]["w"].to(y.dtype)).float() * _gelu_tanh(gate.float())).to(y.dtype)
        x = x + h @ fp["fc2"]["w"].to(h.dtype)
    return t5_layer_norm(params["norm"], x)


def encode_prompts(cfg: T5Config, params: Params, ids: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """WanTextEncoder.forward semantics: run the encoder, zero the padding
    positions (utils/wan_wrapper.py:43-55). Returns [B, text_len, dim]."""
    ctx = t5_encode(cfg, params, ids, mask)
    return ctx * (mask.to(ctx.device)[..., None] > 0).to(ctx.dtype)
