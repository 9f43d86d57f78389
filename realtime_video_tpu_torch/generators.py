"""Wan 2.1-style generator facade (port of realtime_video_tpu/generators.py,
after the reference's wan/text2video.py `WanT2V.generate`): the 50-step CFG
teacher over a whole clip. Only text-to-video is ported; the image-to-video
generator needs the i2v model, its CLIP tower and the image cross-attention.
"""
from __future__ import annotations

from typing import Tuple

import torch

from realtime_video_tpu_torch.config import SAMPLE_NEG_PROMPT, VAE_STRIDE, load_server_config
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.pipelines.bidirectional_diffusion_inference import (
    BidirectionalDiffusionInferencePipeline,
)


class WanT2V:
    """Text-to-video with the many-step CFG teacher, on the generator's device."""

    def __init__(self, generator: WanDiffusion, text_encoder, vae,
                 sample_solver: str = "unipc", sampling_steps: int = 50,
                 guidance_scale: float = 5.0, shift: float = 5.0):
        config = load_server_config(sample_solver=sample_solver, sampling_steps=sampling_steps,
                                    guidance_scale=guidance_scale, timestep_shift=shift)
        self.pipeline = BidirectionalDiffusionInferencePipeline(config, generator, text_encoder,
                                                                vae)
        self.vae = vae

    @staticmethod
    def latent_shape(size: Tuple[int, int], frame_num: int) -> Tuple[int, ...]:
        """[1, latent frames, 16, latent h, latent w] of a (width, height) clip."""
        w, h = size
        return (1, (frame_num - 1) // VAE_STRIDE[0] + 1, 16, h // VAE_STRIDE[1],
                w // VAE_STRIDE[2])

    def generate(self, input_prompt: str, size: Tuple[int, int] = (832, 480),
                 frame_num: int = 81, n_prompt: str = "", seed: int = -1,
                 offload_model: bool = False, profile: bool = False) -> torch.Tensor:
        """Pixels [T, 3, H, W] in [-1, 1] on the generator's device (the
        latents [1, F, 16, h, w] without a VAE). The noise is drawn in f32
        from a torch.Generator seeded with `seed` (0 when negative) and cast
        to bf16, as the JAX generator casts its draw. `profile` is the
        pipeline's (its times in `pipeline.last_profile`)."""
        del offload_model  # API parity: the weights stay on the card
        gen = self.pipeline.generator
        if seed < 0:
            seed = 0
        rng = torch.Generator(device=gen.device).manual_seed(seed)
        noise = torch.randn(self.latent_shape(size, frame_num), generator=rng,
                            dtype=torch.float32, device=gen.device).to(torch.bfloat16)
        neg_embeds = None
        if self.pipeline.text_encoder is not None:
            neg_embeds = self.pipeline.text_encoder(
                text_prompts=[n_prompt or SAMPLE_NEG_PROMPT])["prompt_embeds"]
        video, latents = self.pipeline.inference(
            noise, text_prompts=[input_prompt], neg_prompt_embeds=neg_embeds,
            return_latents=True, profile=profile)
        if video is None:
            return latents
        # the pipeline maps to [0, 1]; Wan's generators return [-1, 1]
        return video[0] * 2.0 - 1.0
