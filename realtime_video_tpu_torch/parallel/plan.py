"""Serving memory plan of one stream on one device (port of
realtime_video_tpu/parallel/plan.py's `serving_memory_plan` at tp=1).

The reference serves the 14B on one B200 (weights ~28 GB bf16 + up to 25 GB
KV cache, README.md:31-32); one 80 GB H100 holds the same. The plan counts
the DiT's parameter bytes from the port's own init run on the `meta` device
(shapes and dtypes, no memory), the KV and cross-attention caches and the
JAX plan's estimate of the forward's high-water mark. It is a steady-state
estimate: it leaves out the load peak (f32 init draws, bf16 and int8 trees
side by side while quantising) and the VAE's transients, so it is printed
beside the measured peaks and guards nothing. The sharding helpers of the
JAX module (tp > 1) are not ported: the port serves on one card.
"""
from __future__ import annotations

import dataclasses

import torch

from realtime_video_tpu_torch.config import WanModelConfig
from realtime_video_tpu_torch.models import wan_dit


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Byte budget for serving one stream on one device."""

    dit_params: int
    kv_cache: int
    crossattn_cache: int
    activations: int  # DiT forward high-water estimate
    total: int

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
    params = wan_dit.init_wan_params(cfg, None, "meta", dtype)
    total, stack = 0, [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += node.numel() * node.element_size()
    return total


def serving_memory_plan(cfg: WanModelConfig, window_frames: int = 21,
                        frame_seqlen: int = 1560, batch: int = 1,
                        dtype=torch.bfloat16) -> ServingPlan:
    """Plan for KV-cached block-causal serving on one device.

    window_frames=21 is the reference's worst-case global window (32760
    tokens, wan_wrapper.py:153 / README.md:32); the realtime server runs
    kv_cache_num_frames + 3 = 6."""
    isz = torch.empty((), dtype=dtype).element_size()
    dit = dit_param_bytes(cfg, dtype)
    S = window_frames * frame_seqlen
    kv = 2 * cfg.num_layers * batch * S * cfg.num_heads * cfg.head_dim * isz
    cross = 2 * cfg.num_layers * batch * cfg.text_len * cfg.num_heads * cfg.head_dim * isz
    # forward high-water: per-layer live set at the 3-frame block
    #   x + 2 residual copies [B,L,D], qkv [B,L,3D], ffn hidden [B,L,ffn],
    #   attention window K/V slice [B,S,N,Dh]; x1.5 for the attention's f32
    #   tiles and the unpatchify buffers (the JAX plan's estimate)
    L = 3 * frame_seqlen
    acts = batch * L * (3 * cfg.dim + 3 * cfg.dim + cfg.ffn_dim) * isz \
        + 2 * batch * S * cfg.num_heads * cfg.head_dim * isz
    acts = int(acts * 1.5)
    return ServingPlan(dit, kv, cross, acts, dit + kv + cross + acts)

