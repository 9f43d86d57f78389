"""JAX parameter trees -> the port's parameter trees.

The port keeps the JAX package's parameter layout (layer-stacked DiT blocks,
linear weights [in, out], VAE conv weights [kt, kh, kw, ci, co]), so a tree of
numpy leaves (e.g. `jax.device_get(params)`) converts leaf by leaf. bfloat16
leaves (numpy's `bfloat16` extension dtype) go through float32, which is
exact. This module imports no JAX.

int8 trees (`quantize_wan_linears`, `quantize_vae_params`) carry across as they
are: `w_q` stays int8, and the `scale` and `a_scale` beside it stay float32
whatever `dtype` asks, since they are dequantisation factors, not weights.
TAEHV trees keep their structure, but conv weights turn from JAX's HWIO to
F.conv2d's [co, ci, kh, kw] (`taehv_params_from_jax`).
A DiT linear's `w_q` [.., in, out] is stored [.., out, in] and handed out as
that view, the fused int8 kernel's K-major layout (`hopper_int8_mm.k_major`),
as `quantize_wan_linears` builds it; a VAE conv's `w_q` [kt, 3, 3, ci, co] is
stored [co, kt, 3, 3, cp] (`hopper_conv.k_major`), as `quantize_vae_params`
builds it.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from realtime_video_tpu_torch.ops import hopper_conv
from realtime_video_tpu_torch.ops.hopper_int8_mm import k_major

#: leaves of an int8 node that keep float32
_INT8_SCALES = ("scale", "a_scale")


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_from_numpy(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Map dicts, lists and tuples of array leaves to torch tensors on
    `device`; floating leaves are cast to `dtype` when it is given, except the
    float32 scales of an int8 node (a dict holding `w_q`)."""
    if isinstance(tree, dict):
        int8_node = "w_q" in tree
        return {k: _leaf(v, device, None) if int8_node and k in _INT8_SCALES
                else tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)


def wan_params_from_jax(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """A JAX `init_wan_params` or `quantize_wan_linears` tree (numpy leaves)
    as the port's DiT params. dtype applies to the bf16 leaves only; the time
    MLP stays f32 as in JAX. Int8 `w_q` leaves come K-major (`k_major`)."""

    def convert(node):
        if isinstance(node, dict):
            if "w_q" in node:
                return {k: (k_major(torch.from_numpy(np.array(v))).to(device) if k == "w_q"
                            else _leaf(v, device, None) if k in _INT8_SCALES
                            else convert(v)) for k, v in node.items()}
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        t = _leaf(node, device, None)
        return t.to(dtype) if dtype is not None and t.dtype == torch.bfloat16 else t

    return convert(tree)


def vae_params_from_jax(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """A JAX `init_vae_params` or `quantize_vae_params` tree (numpy leaves) as
    the port's VAE params. Int8 conv `w_q` leaves come K-major
    (`hopper_conv.k_major`)."""
    if isinstance(tree, dict):
        out = {k: vae_params_from_jax(v, device, dtype) for k, v in tree.items()
               if not ("w_q" in tree and k in _INT8_SCALES + ("w_q",))}
        if "w_q" in tree:
            out.update({k: _leaf(tree[k], device, None) for k in _INT8_SCALES if k in tree})
            out["w_q"] = hopper_conv.k_major(torch.from_numpy(np.array(tree["w_q"]))).to(device)
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(vae_params_from_jax(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)


def t5_params_from_jax(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """A JAX `init_t5_encoder_params` tree (numpy leaves) as the port's umT5
    params (`models/t5.py`, the same layout). dtype applies to every floating
    leaf but the relative position embeddings, which stay f32 as in JAX."""
    out = tree_from_numpy(tree, device, dtype)
    out["blocks"]["rel_emb"] = _leaf(tree["blocks"]["rel_emb"], device, torch.float32)
    return out


def taehv_params_from_jax(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """A JAX `init_taehv_params` or `convert_taehv_checkpoint` tree (numpy
    leaves, conv weights HWIO) as the port's TAEHV params (`models/taehv.py`:
    weights [co, ci, kh, kw]); the layers' None entries stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: taehv_params_from_jax(v, device, dtype) for k, v in tree.items()}
        if "w" in tree:
            out["w"] = out["w"].permute(3, 2, 0, 1).contiguous()
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(taehv_params_from_jax(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)
