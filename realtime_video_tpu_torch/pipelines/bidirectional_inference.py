"""The few-step distilled bidirectional sampler: a denoise -> renoise chain
over the whole clip (port of realtime_video_tpu/pipelines/bidirectional_inference.py,
after the reference's pipeline/bidirectional_inference.py).

At each timestep of `denoising_step_list` one train-mode forward over all
of the clip's tokens predicts x0, which is renoised to the next timestep;
the last prediction is the sample. The JAX pipeline attends under an
all-true [L, L] mask (1 GB at 32760 tokens); here the forward takes no mask,
which is the same function, and goes to the attention kernel's unmasked
window on a card. The renoise draws come from `noise_fn` (one per step but
the last), as in `WanDiffusion.make_denoise_block_fn`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import (
    NoiseFn,
    WanDiffusion,
    generator_noise,
)
from realtime_video_tpu_torch.pipelines.causal_diffusion_inference import (
    ProfileClock,
    decode_video,
    prompt_embeds_of,
)


class BidirectionalInferencePipeline:
    def __init__(self, config, generator: WanDiffusion, text_encoder=None, vae=None):
        self.generator = generator
        self.text_encoder = text_encoder
        self.vae = vae
        self.denoising_step_list: Tuple[float, ...] = tuple(
            float(s) for s in config.denoising_step_list)
        self.last_profile: Optional[dict] = None

    def inference(self, noise: torch.Tensor, text_prompts: Optional[List[str]] = None,
                  prompt_embeds: Optional[torch.Tensor] = None, return_latents: bool = False,
                  seed: int = 0, noise_fn: Optional[NoiseFn] = None, profile: bool = False):
        """Denoise the clip `noise` [B, F, C, h, w] and decode it: video
        [B, T, 3, H, W] in [0, 1] (None without a VAE); (video, latents)
        with `return_latents`. Renoise draws come from `noise_fn` (default:
        a torch.Generator on the DiT's device seeded with `seed`). `profile`
        syncs the device after every step and after the decode and keeps
        the times (ms) in `last_profile`."""
        gen = self.generator
        b, f = noise.shape[:2]
        cross = gen.compute_crossattn_cache(prompt_embeds_of(self, text_prompts, prompt_embeds))
        if noise_fn is None:
            noise_fn = generator_noise(torch.Generator(device=gen.device).manual_seed(seed))

        steps = self.denoising_step_list
        noisy = x0 = noise.to(gen.device, gen.dtype)
        clock = ProfileClock(gen.device, profile)
        step_ms = []
        for i, t_val in enumerate(steps):
            t = torch.full((b, f), t_val, dtype=torch.float32, device=gen.device)
            _, x0, _ = gen.forward(noisy, cross, t, mode="train")
            if i < len(steps) - 1:
                nz = noise_fn(tuple(x0.shape), x0.dtype, x0.device)
                tn = torch.full((b, f), steps[i + 1], dtype=torch.float32, device=gen.device)
                noisy = gen.schedule.add_noise(x0, nz, tn)
            step_ms.append(clock.lap())

        video = decode_video(self.vae, x0)
        decode_ms = clock.lap()
        if profile:
            self.last_profile = dict(step_ms=step_ms, decode_ms=decode_ms)
        if return_latents:
            return video, x0
        return video
