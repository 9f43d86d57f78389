"""Many-step block-causal sampling with classifier-free guidance and two KV
caches (port of realtime_video_tpu/pipelines/causal_diffusion_inference.py,
after the reference's `CausalDiffusionInferencePipeline`).

Per block a fresh solver (UniPC, or DPM++ on the explicit
`get_sampling_sigmas` ladder) runs `sampling_steps` steps; each step is a
conditional and an unconditional decode forward, each with its own cache,
guided as flow_u + g * (flow_c - flow_u). After the block both caches are
rewritten with its clean latents at `context_noise`. An `initial_latent`
prefills both caches at t = 0 and passes through to the output. The caches
hold the model's window (21 frames, 32760 tokens at 832x480, when
`local_attn_size` is -1). The pipeline runs on the generator's device.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from realtime_video_tpu_torch.config import SAMPLE_NEG_PROMPT
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.solvers import make_solver


def _rounded(pipe, embeds: torch.Tensor) -> torch.Tensor:
    """Embeddings on the generator's device, rounded to bf16 as the JAX
    pipelines round them, in the DiT's dtype."""
    gen = pipe.generator
    return embeds.to(gen.device, torch.bfloat16).to(gen.dtype)


def prompt_embeds_of(pipe, text_prompts, prompt_embeds) -> torch.Tensor:
    """The prompt's embeddings (from `text_prompts` when not given), rounded."""
    if prompt_embeds is None:
        if pipe.text_encoder is None or text_prompts is None:
            raise ValueError("pass prompt_embeds, or text_prompts with a text encoder")
        prompt_embeds = pipe.text_encoder(text_prompts=text_prompts)["prompt_embeds"]
    return _rounded(pipe, prompt_embeds)


def prompt_pair(pipe, batch: int, text_prompts, prompt_embeds, neg_prompt_embeds):
    """(cond, uncond) embeddings, rounded: the prompt's, and the negative
    prompt's from the text encoder when not given, else zeros."""
    cond = prompt_embeds_of(pipe, text_prompts, prompt_embeds)
    if neg_prompt_embeds is None:
        if pipe.text_encoder is None:
            return cond, torch.zeros_like(cond)
        neg_prompt_embeds = pipe.text_encoder(
            text_prompts=[SAMPLE_NEG_PROMPT] * batch)["prompt_embeds"]
    return cond, _rounded(pipe, neg_prompt_embeds)


class ProfileClock:
    """Host laps (ms) of a pipeline's phases: with `on`, each lap first
    waits for the generator's card, so it spans the work launched in it."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on = device, on
        self.t = time.perf_counter()

    def lap(self) -> float:
        if self.on and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        ms, self.t = (now - self.t) * 1e3, now
        return ms


def decode_video(vae, latents: torch.Tensor) -> Optional[torch.Tensor]:
    """The VAE's pixels mapped from [-1, 1] to [0, 1], or None without a VAE."""
    if vae is None:
        return None
    return torch.clamp(vae.decode_to_pixel(latents) * 0.5 + 0.5, 0.0, 1.0)


class CausalDiffusionInferencePipeline:
    def __init__(self, config, generator: WanDiffusion, text_encoder=None, vae=None):
        self.generator = generator
        self.text_encoder = text_encoder
        self.vae = vae
        self.num_frame_per_block = config.get("num_frame_per_block", 1)
        self.guidance_scale = float(config.get("guidance_scale", 5.0))
        self.sample_solver = config.get("sample_solver", "unipc")
        self.sampling_steps = int(config.get("sampling_steps", 50))
        self.shift = float(config.get("timestep_shift", 5.0))
        self.context_noise = float(config.get("context_noise", 0))
        self.local_attn_size = generator.cfg.local_attn_size
        self.kv_cache_pos = None
        self.kv_cache_neg = None
        self.last_profile: Optional[dict] = None

    def _forward(self, kv, cross, noisy, t, current_start: int, max_attn: int):
        """One decode forward that writes `noisy`'s K/V into `kv`."""
        flow, _, kv = self.generator.forward(noisy, cross, t, kv, current_start, "decode",
                                             max_attn)
        return flow, kv

    def _forward_cfg(self, cross_pos, cross_neg, noisy, t, current_start: int,
                     max_attn: int) -> torch.Tensor:
        flow_c, self.kv_cache_pos = self._forward(self.kv_cache_pos, cross_pos, noisy, t,
                                                  current_start, max_attn)
        flow_u, self.kv_cache_neg = self._forward(self.kv_cache_neg, cross_neg, noisy, t,
                                                  current_start, max_attn)
        return flow_u + self.guidance_scale * (flow_c - flow_u)

    def _init_caches(self, batch_size: int, fsl: int, dtype) -> None:
        cfg = self.generator.cfg
        size = self.local_attn_size * fsl if self.local_attn_size != -1 else 21 * fsl
        self.kv_cache_pos = self.kv_cache_neg = None  # free the old buffers first
        self.kv_cache_pos, self.kv_cache_neg = (
            kvc.init_kv_cache(cfg.num_layers, batch_size, size, cfg.num_heads, cfg.head_dim,
                              dtype, self.generator.device) for _ in range(2))

    def inference(self, noise: torch.Tensor, text_prompts: Optional[List[str]] = None,
                  prompt_embeds: Optional[torch.Tensor] = None,
                  neg_prompt_embeds: Optional[torch.Tensor] = None,
                  initial_latent: Optional[torch.Tensor] = None,
                  return_latents: bool = False, profile: bool = False):
        """Sample `noise` [B, F, C, h, w] block by block (after
        `initial_latent` [B, Fi, C, h, w] when given) and decode it: video
        [B, T, 3, H, W] in [0, 1] (None without a VAE); (video, latents) with
        `return_latents`. Latents and caches are in the DiT's dtype.
        `profile` syncs the device after every block and after the decode
        and keeps the times (ms) in `last_profile`."""
        gen = self.generator
        nfpb = self.num_frame_per_block
        b, num_frames, _, h, w = noise.shape
        if num_frames % nfpb:
            raise ValueError(f"{num_frames} noise frames: not a multiple of {nfpb}")
        fsl = gen.cfg.frame_seq_length(h, w)
        max_attn = gen.cfg.max_attention_size(fsl)
        noise = noise.to(gen.device, gen.dtype)
        cond, uncond = prompt_pair(self, b, text_prompts, prompt_embeds, neg_prompt_embeds)

        clock = ProfileClock(gen.device, profile)
        cross_pos = gen.compute_crossattn_cache(cond)
        cross_neg = gen.compute_crossattn_cache(uncond)
        self._init_caches(b, fsl, gen.dtype)

        outputs = []
        n_init = 0
        if initial_latent is not None:
            # prefill both caches with the clean context at t = 0
            initial_latent = initial_latent.to(gen.device, gen.dtype)
            n_init = initial_latent.shape[1]
            t_init = torch.zeros((b, n_init), dtype=torch.float32, device=gen.device)
            _, self.kv_cache_pos = self._forward(self.kv_cache_pos, cross_pos, initial_latent,
                                                 t_init, 0, max_attn)
            _, self.kv_cache_neg = self._forward(self.kv_cache_neg, cross_neg, initial_latent,
                                                 t_init, 0, max_attn)
            outputs.append(initial_latent)
        init_ms = clock.lap()

        block_ms = []
        current_start_frame = n_init
        for _ in range(num_frames // nfpb):
            lo = current_start_frame - n_init
            latent = noise[:, lo:lo + nfpb]
            solver = make_solver(self.sample_solver, self.sampling_steps, self.shift)
            for t_val in solver.timesteps:
                t = torch.full((b, nfpb), float(t_val), dtype=torch.float32, device=gen.device)
                flow = self._forward_cfg(cross_pos, cross_neg, latent, t,
                                         current_start_frame * fsl, max_attn)
                latent = solver.step(flow, float(t_val), latent)
            outputs.append(latent)

            # the clean-context refresh of both caches
            t_ctx = torch.full((b, nfpb), self.context_noise, dtype=torch.float32,
                               device=gen.device)
            _, self.kv_cache_pos = self._forward(self.kv_cache_pos, cross_pos, latent, t_ctx,
                                                 current_start_frame * fsl, max_attn)
            _, self.kv_cache_neg = self._forward(self.kv_cache_neg, cross_neg, latent, t_ctx,
                                                 current_start_frame * fsl, max_attn)
            current_start_frame += nfpb
            block_ms.append(clock.lap())

        latents = torch.cat(outputs, dim=1)
        video = decode_video(self.vae, latents)
        decode_ms = clock.lap()
        if profile:
            self.last_profile = dict(init_ms=init_ms, block_ms=block_ms, decode_ms=decode_ms)
        if return_latents:
            return video, latents
        return video
