"""Serving memory plan of one stream on a tp-way mesh, and the placement
of a serving tree on it (port of realtime_video_tpu/parallel/plan.py).

The reference serves the 14B on one B200 (weights ~28 GB bf16 + up to 25 GB
KV cache, README.md:31-32); one 80 GB H100 holds the same. The plan counts
the DiT's parameter bytes per rank from the port's own init run on the
`meta` device (shapes and dtypes, no memory) under the tp specs of
`parallel/sharding.py`, the KV and cross-attention caches split on heads
and the JAX plan's estimate of the forward's high-water mark. It is a
steady-state estimate: it leaves out the load peak (f32 init draws, bf16 and
int8 trees side by side while quantising) and the VAE's transients, so it is
printed beside the measured peaks and guards nothing. `ServingPlan.fits`
plans against the H100's memory only (the JAX module's v5e and v5p sizes are
TPU parts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from realtime_video_tpu_torch.config import WanModelConfig
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.parallel import sharding as sh

#: an H100's memory, where no card is there to ask
H100_BYTES = 80 * 1024**3
#: the share of a card held back for the allocator's fragmentation and the
#: kernels' temporaries
RESERVE_FRAC = 0.15


def _per_chip_bytes(shapes: Dict[str, Any], pspecs: Dict[str, Any],
                    axis_sizes: Dict[str, int]) -> int:
    """Bytes a rank holds of a tree of (meta) tensors under its spec tree:
    each leaf's bytes divided by the sizes of the axes it is split on."""
    if isinstance(shapes, dict):
        return sum(_per_chip_bytes(v, pspecs[k], axis_sizes) for k, v in shapes.items())
    div = math.prod(axis_sizes.get(ax, 1) for ax in pspecs if ax is not None)
    return shapes.numel() * shapes.element_size() // div


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Byte budget of one rank for serving one stream."""

    dit_params: int
    kv_cache: int
    crossattn_cache: int
    activations: int  # DiT forward high-water estimate
    total: int

    def fits(self) -> bool:
        """True if the plan fits an H100 less RESERVE_FRAC: the card's own
        memory where one is there, else 80 GiB."""
        cap = (torch.cuda.get_device_properties(0).total_memory if torch.cuda.is_available()
               else H100_BYTES)
        return self.total <= cap * (1 - RESERVE_FRAC)

    def table(self) -> str:
        gb = 1024**3
        rows = [
            ("DiT params", self.dit_params),
            ("KV cache", self.kv_cache),
            ("cross-attn cache", self.crossattn_cache),
            ("activation high-water", self.activations),
            ("total / chip", self.total),
        ]
        return "\n".join(f"{k:22s} {v / gb:7.2f} GB" for k, v in rows)


def dit_param_bytes(cfg: WanModelConfig, dtype=torch.bfloat16) -> int:
    """Bytes of the DiT's parameters as `init_wan_params` makes them (its
    f32 leaves included), counted on the meta device."""
    return dit_param_bytes_per_rank(cfg, 1, dtype)


def dit_param_bytes_per_rank(cfg: WanModelConfig, tp: int, dtype=torch.bfloat16) -> int:
    """A rank's bytes of the DiT's parameters under `wan_param_pspecs` at tp."""
    params = wan_dit.init_wan_params(cfg, None, "meta", dtype)
    return _per_chip_bytes(params, sh.wan_param_pspecs(params), {"tp": tp})


def serving_memory_plan(cfg: WanModelConfig, tp: int = 1, window_frames: int = 21,
                        frame_seqlen: int = 1560, batch: int = 1,
                        dtype=torch.bfloat16) -> ServingPlan:
    """A rank's plan for KV-cached block-causal serving on a tp-way mesh
    (plan.py:76-120).

    window_frames=21 is the reference's worst-case global window (32760
    tokens, wan_wrapper.py:153 / README.md:32); the realtime server runs
    kv_cache_num_frames + 3 = 6."""
    isz = torch.empty((), dtype=dtype).element_size()
    dit = dit_param_bytes_per_rank(cfg, tp, dtype)
    S = window_frames * frame_seqlen
    kv = 2 * cfg.num_layers * batch * S * cfg.num_heads * cfg.head_dim * isz // tp
    cross = 2 * cfg.num_layers * batch * cfg.text_len * cfg.num_heads * cfg.head_dim * isz // tp
    # forward high-water: per-layer live set at the 3-frame block
    #   x + 2 residual copies [B,L,D] replicated, qkv [B,L,3D/tp], ffn hidden
    #   [B,L,ffn/tp], attention window K/V slice [B,S,N/tp,Dh]; x1.5 for the
    #   attention's f32 tiles and the unpatchify buffers (the JAX plan's estimate)
    L = 3 * frame_seqlen
    acts = batch * L * (3 * cfg.dim + (3 * cfg.dim + cfg.ffn_dim) // tp) * isz \
        + 2 * batch * S * cfg.num_heads * cfg.head_dim * isz // tp
    acts = int(acts * 1.5)
    return ServingPlan(dit, kv, cross, acts, dit + kv + cross + acts)


def shard_for_serving(params: Dict[str, Any], kv: Optional[Dict[str, Any]],
                      cross: Optional[Dict[str, Any]], mesh):
    """(params, kv_cache, crossattn_cache) as this rank holds them on the
    mesh's tp axis (plan.py:123-135): the tree's slices, the caches' heads;
    a None cache stays None."""
    params = sh.shard_wan_params(params, mesh)
    if kv is not None:
        kv = sh.shard_kv_cache(kv, mesh)
    if cross is not None:
        cross = sh.shard_crossattn_cache(cross, mesh)
    return params, kv, cross

