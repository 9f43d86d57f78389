"""Tensor-parallel splits of the Wan DiT and umT5 trees, Megatron style (port
of realtime_video_tpu/parallel/sharding.py).

A spec is a tuple with one entry per dim of a leaf: None (whole) or "tp"
(split into tp equal slices; rank r holds slice r), the JAX package's
PartitionSpecs as tuples, with the same dims:
  * q / k / v and ffn fc1: the output columns (heads, FFN columns);
  * o and ffn fc2: the input rows, their outputs summed over tp after the
    product (`collectives.reduce_from_tp`), their bias replicated and added
    once, after the sum;
  * the q/k RMSNorm scales: the width, as q and k (the norm's sum of squares
    is summed over tp: `models/wan_dit.py`);
  * norms, modulation, embeddings and the head: replicated;
  * the KV and cross-attention caches [L, B, S, N, Dh]: the heads N.

Where GSPMD re-shards, the port slices explicitly, and two leaves differ
from JAX's addressable shards:
  * a fused qkv [L, D, 3D] (`fuse_qkv_params`): JAX's spec splits its
    columns contiguously and re-shards after the split; a rank of the port
    needs its own heads' columns of each of q, k and v, so its shard is
    JAX's unfused q, k and v shards side by side (`w` or `w_q`, `scale`
    and `b` alike);
  * int8 `w_q` [L, in, out] is the view of [L, out, in] storage (the K3
    kernel's K-major layout): every shard is laid out again with
    `hopper_int8_mm.k_major`, since a row-parallel shard (along K) is a
    column slice of the storage.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from realtime_video_tpu_torch.ops import hopper_int8_mm
from realtime_video_tpu_torch.parallel import mesh as mesh_mod

Params = Dict[str, Any]
TP = "tp"


def _attn_specs(fused: bool = False) -> Params:
    col_w, col_b = (None, None, TP), (None, TP)
    specs = {
        "o": {"w": (None, TP, None), "b": (None, None)},
        "norm_q": {"scale": (None, TP)},
        "norm_k": {"scale": (None, TP)},
    }
    if fused:
        specs["qkv"] = {"w": col_w, "b": col_b}
    else:
        for n in ("q", "k", "v"):
            specs[n] = {"w": col_w, "b": col_b}
    return specs


def _replicated(tree: Any) -> Any:
    """Specs of a replicated subtree: (), JAX's P()."""
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return ()


def wan_param_pspecs(params: Params) -> Params:
    """The spec tree of a wan_dit param tree (sharding.py:46-87)."""
    blocks = {
        "self_attn": _attn_specs(fused="qkv" in params["blocks"]["self_attn"]),
        "cross_attn": _attn_specs(),
        "ffn": {
            "fc1": {"w": (None, None, TP), "b": (None, TP)},
            "fc2": {"w": (None, TP, None), "b": (None, None)},
        },
        "modulation": (None, None, None, None),
    }
    if "norm3" in params["blocks"]:
        blocks["norm3"] = {"scale": (None, None), "bias": (None, None)}
    if "k_img" in params["blocks"]["cross_attn"]:
        blocks["cross_attn"]["k_img"] = {"w": (None, None, TP), "b": (None, TP)}
        blocks["cross_attn"]["v_img"] = {"w": (None, None, TP), "b": (None, TP)}
        blocks["cross_attn"]["norm_k_img"] = {"scale": (None, TP)}
    specs: Params = {
        "patch_embedding": {"w": (None, None), "b": (None,)},
        "text_embedding": {
            "fc1": {"w": (None, None), "b": (None,)},
            "fc2": {"w": (None, None), "b": (None,)},
        },
        "time_embedding": {
            "fc1": {"w": (None, None), "b": (None,)},
            "fc2": {"w": (None, None), "b": (None,)},
        },
        "time_projection": {"fc": {"w": (None, None), "b": (None,)}},
        "blocks": blocks,
        "head": {
            "head": {"w": (None, None), "b": (None,)},
            "modulation": (None, None, None),
        },
    }
    if "img_emb" in params:
        specs["img_emb"] = _replicated(params["img_emb"])
    return _fixup_quantized(params, specs)


def _fixup_quantized(params: Params, specs: Params) -> Params:
    """Specs of int8 linears ({w_q, scale, a_scale?, b}, quantize_wan_linears):
    w_q takes w's spec, scale keeps its out-dim split, a_scale [L] is
    replicated (sharding.py:90-114)."""
    if isinstance(params, dict):
        if "w_q" in params and isinstance(specs, dict) and "w" in specs:
            w = specs["w"]
            fixed = {"w_q": w, "scale": (w[0], w[2]) if len(w) == 3 else (None, None)}
            if "a_scale" in params:
                fixed["a_scale"] = (w[0],) if len(w) == 3 else (None,)
            if "b" in params and "b" in specs:
                fixed["b"] = specs["b"]
            return fixed
        if isinstance(specs, dict):
            return {k: _fixup_quantized(params[k], specs[k]) if k in params else v
                    for k, v in specs.items()}
    return specs


def shard_leaf(x: torch.Tensor, spec: tuple, tp_size: int, tp_rank: int,
               pieces: int = 1) -> torch.Tensor:
    """Rank `tp_rank`'s slice of `x` under `spec`. With `pieces` > 1 the split
    dim holds that many equal parts side by side (a fused qkv: q | k | v),
    each split on its own and the slices put side by side again."""
    if TP not in spec or tp_size == 1:
        return x
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} does not fit a leaf of shape {tuple(x.shape)}")
    dim = spec.index(TP)
    parts = x.chunk(pieces, dim=dim) if pieces > 1 else (x,)
    out = []
    for part in parts:
        n = part.shape[dim]
        if n % tp_size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} ({n} a part) does not split "
                             f"over tp={tp_size}")
        step = n // tp_size
        out.append(part.narrow(dim, tp_rank * step, step))
    y = torch.cat(out, dim=dim) if pieces > 1 else out[0]
    return y.contiguous()


def shard_params(params: Params, specs: Params, tp_size: int, tp_rank: int) -> Params:
    """This rank's tree: every leaf sliced by its spec, a fused qkv three
    parts at a time, int8 `w_q` laid out K-major again."""

    def leaf(x, spec, in_fused, key):
        y = shard_leaf(x, spec, tp_size, tp_rank, pieces=3 if in_fused else 1)
        if key == "w_q" and y is not x:
            y = hopper_int8_mm.k_major(y)
        return y

    def go(node, spec, in_fused=False):
        if isinstance(node, dict):
            return {k: (go(v, spec[k], in_fused or k == "qkv") if isinstance(v, dict)
                        else leaf(v, spec[k], in_fused, k)) for k, v in node.items()}
        return leaf(node, spec, in_fused, None)

    return go(params, specs)


def shard_wan_params(params: Params, mesh) -> Params:
    """This rank's slice of a wan_dit tree on the mesh's "tp" axis (the tree
    itself where tp is 1): split leaves are new tensors on the leaves'
    device, replicated ones the tree's own."""
    size, rank = mesh_mod.axis_size(mesh, TP), mesh_mod.axis_rank(mesh, TP)
    if size == 1:
        return params
    return shard_params(params, wan_param_pspecs(params), size, rank)


def local_heads(num_heads: int, mesh) -> int:
    """Heads a rank attends over: num_heads / tp (tp must divide them)."""
    size = mesh_mod.axis_size(mesh, TP)
    if num_heads % size:
        raise ValueError(f"tp={size} does not divide {num_heads} heads")
    return num_heads // size


def kv_cache_sharding() -> Dict[str, Optional[tuple]]:
    """KV cache [L, B, S, N, Dh] split on the heads; the end indices (host
    ints) replicated."""
    return {"k": (None, None, None, TP, None), "v": (None, None, None, TP, None),
            "global_end": None, "local_end": None}


def crossattn_cache_sharding() -> Dict[str, tuple]:
    spec = (None, None, None, TP, None)
    return {"k": spec, "v": spec, "k_img": spec, "v_img": spec}


def shard_kv_cache(kv: Params, mesh) -> Params:
    """This rank's heads of a serving KV cache."""
    size, rank = mesh_mod.axis_size(mesh, TP), mesh_mod.axis_rank(mesh, TP)
    specs = kv_cache_sharding()
    return {k: v if specs[k] is None else shard_leaf(v, specs[k], size, rank)
            for k, v in kv.items()}


def shard_crossattn_cache(cross: Params, mesh) -> Params:
    """This rank's heads of a cross-attention cache (text and image K/V)."""
    size, rank = mesh_mod.axis_size(mesh, TP), mesh_mod.axis_rank(mesh, TP)
    specs = crossattn_cache_sharding()
    return {k: shard_leaf(v, specs[k], size, rank) for k, v in cross.items()}


def t5_param_pspecs(params: Params) -> Params:
    """The umT5 encoder's spec tree (sharding.py:138-160)."""
    del params
    blocks = {
        "norm1": {"scale": (None, None)},
        "attn": {
            "q": {"w": (None, None, TP)},
            "k": {"w": (None, None, TP)},
            "v": {"w": (None, None, TP)},
            "o": {"w": (None, TP, None)},
        },
        "norm2": {"scale": (None, None)},
        "ffn": {
            "gate": {"w": (None, None, TP)},
            "fc1": {"w": (None, None, TP)},
            "fc2": {"w": (None, TP, None)},
        },
        "rel_emb": (None, None, None),
    }
    return {"token_embedding": (None, None), "blocks": blocks, "norm": {"scale": (None,)}}


def shard_t5_params(params: Params, mesh) -> Params:
    size, rank = mesh_mod.axis_size(mesh, TP), mesh_mod.axis_rank(mesh, TP)
    if size == 1:
        return params
    return shard_params(params, t5_param_pspecs(params), size, rank)
