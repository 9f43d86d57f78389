"""Training model scaffold (port of realtime_video_tpu/training/base.py;
reference model/base.py BaseModel / SelfForcingModel).

Holds the causal generator, the frozen real score, the trainable fake
score, the text encoder and the VAE, the block-consistent timestep sampler,
and `_run_generator`: a rollout of a random number of blocks, drawn on the
host from a seed shared by every data-parallel worker (in place of
dist.broadcast, base.py:139-141). A rollout longer than max_rollout_frames is
re-anchored: its last frame is decoded to pixels and re-encoded as an image
latent, which replaces the frames before the last window (base.py:156-167).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.pipelines.self_forcing_training import (
    SelfForcingTrainingPipeline,
)
from realtime_video_tpu_torch.training.draws import Draws
from realtime_video_tpu_torch.training.losses import sample_block_timesteps

Params = Dict[str, Any]


class SelfForcingModel:
    def __init__(self, generator: WanDiffusion, real_score: WanDiffusion,
                 fake_score: WanDiffusion, config, text_encoder=None, vae=None):
        self.generator = generator
        self.real_score = real_score
        self.fake_score = fake_score
        self.text_encoder = text_encoder
        self.vae = vae
        self.config = config
        self.num_frame_per_block = config.get("num_frame_per_block", 3)
        self.num_training_frames = int(config.get("num_training_frames", 21))
        self.max_rollout_frames = 21  # the gradient window (base.py:137)
        self.same_step_across_blocks = config.get("same_step_across_blocks", True)
        self.pipeline = SelfForcingTrainingPipeline(
            config.get("denoising_step_list", [1000, 750, 500, 250]),
            generator.schedule,
            generator,
            num_frame_per_block=self.num_frame_per_block,
            same_step_across_blocks=self.same_step_across_blocks,
            last_step_only=config.get("last_step_only", False),
            context_noise=config.get("context_noise", 0),
        )

    # -- timestep sampling (base.py:48-95) --------------------------------

    def _get_timestep(self, draws: Draws, batch: int, num_frames: int, min_t: int = 0,
                      device=None) -> torch.Tensor:
        return sample_block_timesteps(draws, batch, num_frames, self.num_frame_per_block,
                                      min_t=min_t, device=device)

    # -- rollout (base.py:103-180) ----------------------------------------

    def rollout_num_blocks(self, step_seed: int) -> int:
        """The rollout's length in blocks, the same on every worker (a shared
        host seed in place of dist.broadcast)."""
        max_blocks = self.num_training_frames // self.num_frame_per_block
        return int(np.random.RandomState(step_seed).randint(1, max_blocks + 1))

    def _run_generator(self, gen_params: Params, noise: torch.Tensor,  # [B, F_total, C, h, w]
                       crossattn_cache: Dict[str, torch.Tensor], draws: Draws,
                       step_seed: int = 0, initial_latent: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred [B, F_roll, C, h, w], exit flags), F_roll the host-drawn
        length, re-anchored past max_rollout_frames."""
        del initial_latent
        nb = self.rollout_num_blocks(step_seed)
        sliced = noise[:, :nb * self.num_frame_per_block]
        pred, flags = self.pipeline.inference_with_trajectory(gen_params, sliced,
                                                              crossattn_cache, draws)
        if pred.shape[1] > self.max_rollout_frames and self.vae is not None:
            # re-anchor: decode the last frame, re-encode it as an image
            # latent; the gradient stays on the last window (base.py:156-167)
            tail = pred[:, -(self.max_rollout_frames - 1):]
            with torch.no_grad():
                last_pixels = self.vae.decode_to_pixel(pred[:, -1:].detach())
                anchor = self.vae.encode_to_latent(last_pixels)[:, :1]
            pred = torch.cat([anchor.to(pred.dtype), tail], dim=1)
        return pred, flags
