"""The 50-step CFG teacher over a whole clip (port of
realtime_video_tpu/pipelines/bidirectional_diffusion_inference.py, after the
reference's `BidirectionalDiffusionInferencePipeline` and Wan 2.1's
text2video.py).

Every step runs a conditional and an unconditional train-mode forward over
all of the clip's tokens, with no mask and no cache (32760 tokens at 81
frames of 832x480, each attending to all of them: the attention kernel's
unmasked window on a card), guided as flow_u + g * (flow_c - flow_u), and
one solver (UniPC, or DPM++ on the explicit `get_sampling_sigmas` ladder)
steps the latents. The pipeline runs on the generator's device; the JAX
package's sequence-parallel mesh is not ported.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.pipelines.causal_diffusion_inference import (
    ProfileClock,
    decode_video,
    prompt_pair,
)
from realtime_video_tpu_torch.solvers import make_solver


class BidirectionalDiffusionInferencePipeline:
    def __init__(self, config, generator: WanDiffusion, text_encoder=None, vae=None):
        self.generator = generator
        self.text_encoder = text_encoder
        self.vae = vae
        self.guidance_scale = float(config.get("guidance_scale", 5.0))
        self.sample_solver = config.get("sample_solver", "unipc")
        self.sampling_steps = int(config.get("sampling_steps", 50))
        self.shift = float(config.get("timestep_shift", 5.0))
        self.last_profile: Optional[dict] = None

    def _forward(self, cross, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        flow, _, _ = self.generator.forward(x, cross, t, mode="train")
        return flow

    def inference(self, noise: torch.Tensor, text_prompts: Optional[List[str]] = None,
                  prompt_embeds: Optional[torch.Tensor] = None,
                  neg_prompt_embeds: Optional[torch.Tensor] = None,
                  return_latents: bool = False, profile: bool = False):
        """Sample the clip `noise` [B, F, C, h, w] and decode it: video
        [B, T, 3, H, W] in [0, 1] (None without a VAE); (video, latents)
        with `return_latents`. `profile` syncs the device after every step
        and after the decode and keeps the times (ms) in `last_profile`."""
        gen = self.generator
        b, f = noise.shape[:2]
        cond, uncond = prompt_pair(self, b, text_prompts, prompt_embeds, neg_prompt_embeds)
        cross_pos = gen.compute_crossattn_cache(cond)
        cross_neg = gen.compute_crossattn_cache(uncond)
        solver = make_solver(self.sample_solver, self.sampling_steps, self.shift)

        latent = noise.to(gen.device, gen.dtype)
        clock = ProfileClock(gen.device, profile)
        step_ms = []
        for t_val in solver.timesteps:
            # one timestep for every frame (wan_wrapper.py:245-248)
            t = torch.full((b, f), float(t_val), dtype=torch.float32, device=gen.device)
            flow_c = self._forward(cross_pos, latent, t)
            flow_u = self._forward(cross_neg, latent, t)
            flow = flow_u + self.guidance_scale * (flow_c - flow_u)
            latent = solver.step(flow, float(t_val), latent)
            step_ms.append(clock.lap())

        video = decode_video(self.vae, latent)
        decode_ms = clock.lap()
        if profile:
            self.last_profile = dict(step_ms=step_ms, decode_ms=decode_ms)
        if return_latents:
            return video, latent
        return video
