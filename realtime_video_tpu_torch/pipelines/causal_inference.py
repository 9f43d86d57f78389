"""Cache state and size helpers of the block-causal sampler that the serving
session uses (port of the cache parts of
realtime_video_tpu/pipelines/causal_inference.py). The offline `inference`
loop is not ported yet."""
from __future__ import annotations

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.ops import kv_cache as kvc


class CausalInferencePipeline:
    def __init__(self, config, generator: WanDiffusion):
        self.generator = generator
        self.num_frame_per_block = config.get("num_frame_per_block", 1)
        #: cache length in frames (-1: the global 21-frame window); the server
        #: sets it per session to kv frames + one block
        self.local_attn_size = generator.cfg.local_attn_size
        self.kv_cache = None
        self.crossattn_cache = None

    def kv_cache_size(self, frame_seqlen: int) -> int:
        if self.local_attn_size != -1:
            return self.local_attn_size * frame_seqlen
        return 21 * frame_seqlen  # 32760 at 832x480 (causal_inference.py:289)

    def _initialize_kv_cache(self, batch_size: int, frame_seqlen: int,
                             dtype=torch.bfloat16) -> None:
        """Zero the cache in place when its shape fits, else allocate it."""
        cache_size = self.kv_cache_size(frame_seqlen)
        cfg = self.generator.cfg
        shape = (cfg.num_layers, batch_size, cache_size, cfg.num_heads, cfg.head_dim)
        if (self.kv_cache is not None and tuple(self.kv_cache["k"].shape) == shape
                and self.kv_cache["k"].dtype == dtype):
            kvc.reset_kv_cache(self.kv_cache)
        else:
            self.kv_cache = None  # free the old buffers before allocating
            self.kv_cache = kvc.init_kv_cache(*shape, dtype=dtype,
                                              device=self.generator.device)

    def _initialize_crossattn_cache(self, prompt_embeds: torch.Tensor) -> None:
        self.crossattn_cache = self.generator.compute_crossattn_cache(prompt_embeds)
