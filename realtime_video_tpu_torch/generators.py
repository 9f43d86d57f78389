"""Wan 2.1-style generator facades (port of realtime_video_tpu/generators.py):
the 50-step CFG generators over a whole clip, after the reference's
wan/text2video.py `WanT2V.generate` and wan/image2video.py `WanI2V.generate`.
Both run on the generator's device; the teacher loop they run
(`BidirectionalDiffusionInferencePipeline`) takes an `sp_mesh` for the
sequence-parallel teacher (Ulysses x ring, one process a card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from realtime_video_tpu_torch.config import SAMPLE_NEG_PROMPT, VAE_STRIDE, load_server_config
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.pipelines.bidirectional_diffusion_inference import (
    BidirectionalDiffusionInferencePipeline,
)
from realtime_video_tpu_torch.pipelines.causal_diffusion_inference import ProfileClock
from realtime_video_tpu_torch.solvers import FlowDPMSolverMultistep, FlowUniPCMultistep


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


def first_frame_mask(frame_num: int, lat_h: int, lat_w: int, device=None) -> torch.Tensor:
    """[1, Tz, 4, lat_h, lat_w] f32: 1 on the conditioning frame, which the
    VAE's 4x temporal grouping sees 4 times (image2video.py:207-214)."""
    lat_f = (frame_num - 1) // VAE_STRIDE[0] + 1
    msk = torch.zeros((frame_num + 3, lat_h, lat_w), device=device)
    msk[:4] = 1.0
    return msk.reshape(lat_f, 4, lat_h, lat_w)[None]


class WanI2V:
    """Image-to-video with the many-step CFG teacher (wan/image2video.py):
    CLIP features condition the i2v cross attention, and the encoded
    conditioning clip [image | zero frames] with its first-frame mask rides
    as 20 extra input channels. The CFG loop is the bidirectional
    pipeline's, given both."""

    def __init__(self, generator: WanDiffusion, text_encoder, vae, clip_encoder=None,
                 sampling_steps: int = 50, guidance_scale: float = 5.0, shift: float = 5.0):
        if generator.cfg.model_type != "i2v":
            raise ValueError("WanI2V needs an i2v model")
        self.config = load_server_config(sampling_steps=sampling_steps,
                                         guidance_scale=guidance_scale, timestep_shift=shift)
        # no VAE in the pipeline: Wan's i2v returns the decode unclamped
        self.pipeline = BidirectionalDiffusionInferencePipeline(self.config, generator,
                                                                text_encoder)
        self.generator = generator
        self.text_encoder = text_encoder
        self.vae = vae
        self.clip_encoder = clip_encoder
        self.last_profile: Optional[dict] = None

    def generate(self, input_prompt: str, img: torch.Tensor, frame_num: int = 81,
                 n_prompt: str = "", seed: int = -1, sample_solver: str = "unipc",
                 return_latents: bool = False, profile: bool = False):
        """i2v sampling (image2video.py:150-300). img [3, H, W] in [-1, 1]
        (numpy or a tensor). Returns pixels [T, 3, H, W] in [-1, 1] on the
        generator's device; (pixels, latents [1, Tz, 16, h, w]) with
        `return_latents`. The noise is drawn as WanT2V draws it (f32 from a
        torch.Generator seeded with `seed`, 0 when negative, cast to bf16).
        The conditioning pixels, the first-frame mask and its latents, and the
        prompt embeddings are rounded to bf16 as the JAX generator rounds
        them, then taken to the DiT's dtype. The forwards attend over every
        token with no mask: the JAX generator's all-true [L, L] mask is the
        same function. The solver's timesteps are set as the JAX generator
        sets them (DPM++ on its own ladder, not `get_sampling_sigmas`).
        `profile` syncs the device after each phase and keeps the times (ms)
        in `last_profile`."""
        gen = self.generator
        dev, bf16 = gen.device, torch.bfloat16
        img = torch.as_tensor(img).to(dev, torch.float32)
        h, w = int(img.shape[1]), int(img.shape[2])
        lat_h, lat_w = h // VAE_STRIDE[1], w // VAE_STRIDE[2]
        lat_f = (frame_num - 1) // VAE_STRIDE[0] + 1
        if seed < 0:
            seed = 0
        rng = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn((1, lat_f, 16, lat_h, lat_w), generator=rng, dtype=torch.float32,
                            device=dev).to(bf16)
        clock = ProfileClock(dev, profile)

        clip_fea = None
        if self.clip_encoder is not None:
            clip_fea = self.clip_encoder(img[None, :, None])
        clip_ms = clock.lap()

        # y = [first-frame mask | the latents of [img | frame_num - 1 zero
        # frames]] (image2video.py:207-246): 4 + 16 channels
        pixels = torch.zeros((1, frame_num, 3, h, w), dtype=bf16, device=dev)
        pixels[0, 0] = img.to(bf16)
        y_lat = self.vae.encode_to_latent(pixels).to(bf16)
        msk = first_frame_mask(frame_num, lat_h, lat_w, dev).to(bf16)
        y = torch.cat([msk, y_lat.to(dev)], dim=2).to(gen.dtype)
        encode_ms = clock.lap()

        shift = float(self.config.get("timestep_shift", 5.0))
        solver = (FlowUniPCMultistep(shift=shift) if sample_solver == "unipc"
                  else FlowDPMSolverMultistep(shift=shift))
        solver.set_timesteps(int(self.config.get("sampling_steps", 40)))
        embeds, neg_embeds = (
            self.text_encoder(text_prompts=[p])["prompt_embeds"]
            for p in (input_prompt, n_prompt or SAMPLE_NEG_PROMPT))
        _, latent = self.pipeline.inference(
            noise, prompt_embeds=embeds, neg_prompt_embeds=neg_embeds,
            return_latents=True, profile=profile, clip_fea=clip_fea, y=y, solver=solver)
        clock.lap()

        video = self.vae.decode_to_pixel(latent)[0]
        decode_ms = clock.lap()
        if profile:
            prof = self.pipeline.last_profile
            self.last_profile = dict(clip_ms=clip_ms, encode_ms=encode_ms,
                                     cross_ms=prof["cross_ms"], step_ms=prof["step_ms"],
                                     decode_ms=decode_ms)
        return (video, latent) if return_latents else video
