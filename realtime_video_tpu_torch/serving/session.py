"""Per-connection text-to-video generation state machine (port of the t2v path
of realtime_video_tpu/serving/session.py, after release_server.py:344-751).

Each block: reset the KV cache, prefill it from the clean context latents
(the first frame re-encoded from pixels after warm-up, the anti-drift
measure), run the few-step denoise, then stream the VAE decode one latent
frame at a time. Block 0 drops its first 3 pixel frames, so a session of n
blocks sends 6 + 12 (n - 1) frames. A prompt change lerps the text embedding
over `interp_steps` blocks.

Random numbers come from a `torch.Generator` seeded with the request's seed
(the JAX package's `jax.random` stream gives other numbers); `noise` and
`noise_fn` let a caller inject both the initial latents noise and the
per-step renoise.

Not ported yet, and refused with an error rather than ignored: v2v input
video, webcam frames, start frames, resume latents and the TAEHV preview tier.
"""
from __future__ import annotations

import asyncio
import logging
import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

import torch

from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import NoiseFn, generator_noise
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule, get_denoising_schedule
from realtime_video_tpu_torch.serving.params import GenerateParams
from realtime_video_tpu_torch.utils.misc import AtomicCounter

log = logging.getLogger(__name__)


class UnsupportedRequest(ValueError):
    """A request field needs a part of the system the port does not have yet."""


def check_supported(params: GenerateParams, config) -> None:
    """Raise UnsupportedRequest for any field that needs code not ported yet."""
    unsupported = {
        "input_video": params.input_video is not None,
        "webcam_mode": params.webcam_mode,
        "start_frame": params.start_frame is not None,
        "resume_latents": params.resume_latents is not None,
        "use_taehv (server config)": bool(config.get("use_taehv", False)),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise UnsupportedRequest(
            f"not supported by the PyTorch port yet: {', '.join(bad)} "
            "(text-to-video only)")


class GenerationSession:
    SESSION_COUNTER = AtomicCounter()

    def __init__(self, params: GenerateParams, config,
                 frame_callback: Optional[Callable] = None, models=None,
                 noise: Optional[torch.Tensor] = None,
                 noise_fn: Optional[NoiseFn] = None):
        check_supported(params, config)
        self.frame_callback = frame_callback or (
            lambda *a, **k: log.warning("No frame callback set!"))
        self.session_id = self.SESSION_COUNTER.increment()
        self.block_idx = 0
        self.params = params
        self.config = config
        self.models = models
        self.params.strength = 1.0  # text-to-video denoises from pure noise

        self.device = models.transformer.device
        self.dtype = models.transformer.dtype
        self.width = params.width // 8 * 8
        self.height = params.height // 8 * 8
        self.latent_width = self.width // 8
        self.latent_height = self.height // 8

        self.interpolated_prompt_embeds: List[torch.Tensor] = []
        self.current_prompt_embeds: Optional[torch.Tensor] = None

        self.kv_cache_num_frames = params.kv_cache_num_frames
        self.num_blocks = params.num_blocks
        # raw pixel frames of the recent blocks, for the anti-drift re-encode
        self.frame_context_cache: deque = deque(
            maxlen=1 + (params.kv_cache_num_frames - 1) * 4)
        self.decode_vae_cache = None
        self.num_frame_per_block = 3

        if self.params.seed is None:
            self.params.seed = 0
        self.generator = torch.Generator(device=self.device).manual_seed(self.params.seed)
        latent_shape = (1, self.num_blocks * self.num_frame_per_block, 16,
                        self.latent_height, self.latent_width)
        self.all_latents = torch.zeros(latent_shape, dtype=self.dtype, device=self.device)
        if noise is None:
            noise = torch.randn(latent_shape, generator=self.generator,
                                dtype=torch.float32, device=self.device)
        self.noise = noise.to(device=self.device, dtype=self.dtype)
        self.noise_fn = noise_fn or generator_noise(self.generator)

        self.current_start_frame = 0
        self.total_frames_sent = 0
        self.disposed = threading.Event()
        self.init_models(models, self.params)
        self.denoising_step_list = get_denoising_schedule(
            self.zero_padded_timesteps, self.params.strength,
            steps=self.params.num_denoising_steps)
        log.info("denoising step list: %s", self.denoising_step_list)

    def dispose(self):
        self.disposed.set()

    @property
    def frame_seq_length(self) -> int:
        return self.models.transformer.cfg.frame_seq_length(
            self.latent_height, self.latent_width)

    def init_models(self, models, params: GenerateParams):
        """Per-session pipeline re-config (release_server.py:542-561): the
        attention window is kv frames + one block, fresh caches, the
        session's shifted schedule."""
        pipeline = models.pipeline
        pipeline.local_attn_size = params.kv_cache_num_frames + pipeline.num_frame_per_block
        self.num_frame_per_block = pipeline.num_frame_per_block
        pipeline._initialize_kv_cache(1, self.frame_seq_length, self.dtype)
        self.schedule = FlowMatchSchedule.create(
            shift=params.timestep_shift, sigma_min=0.0, extra_one_step=True,
            device=self.device)
        self.zero_padded_timesteps = self.schedule.zero_padded_timesteps().cpu().numpy()

    def _max_attn(self) -> int:
        # serving attends over the whole (kv frames + block) cache
        return (self.kv_cache_num_frames + self.num_frame_per_block) * self.frame_seq_length

    def interpolate_prompt_embeds(self, models, new_prompt: str, interpolation_steps: int):
        """Lerp old -> new embeds over N blocks (release_server.py:459-468);
        one step jumps straight to the new prompt."""
        if self.current_prompt_embeds is None:
            return
        p1 = self.current_prompt_embeds
        p2 = models.text_encoder(text_prompts=[new_prompt])["prompt_embeds"].to(self.dtype)
        if interpolation_steps == 1:
            ws = torch.ones((1,), device=p1.device)
        else:
            ws = torch.linspace(0.0, 1.0, interpolation_steps, device=p1.device)
        ws = ws[:, None, None]
        x = p1[0][None] * (1 - ws) + p2[0][None] * ws  # [steps, T, D]
        self.interpolated_prompt_embeds = [x[i][None] for i in range(interpolation_steps)]

    def get_clean_context_frames(self, models) -> torch.Tensor:
        """First frame + the last (k-1) context latents; after warm-up the
        first frame is re-encoded from the oldest cached pixel frame
        (release_server.py:563-576)."""
        k = self.kv_cache_num_frames
        ctx = self.all_latents[:, :self.current_start_frame]
        warmup = (self.block_idx - 1) * self.num_frame_per_block < k
        if self.params.keep_first_frame or warmup:
            if k == 1:
                return ctx[:, :1]
            return torch.cat([ctx[:, :1], ctx[:, 1:][:, -(k - 1):]], dim=1)
        # k == 1 keeps no tail (the reference's `[:, -k + 1:]` is `[:, 0:]`
        # at k=1, which would overflow the (k+3)-frame cache)
        tail = ctx[:, 1:][:, -(k - 1):] if k > 1 else ctx[:, :0]
        blk, fi = self.frame_context_cache[0]
        first_pixels = blk[:, fi:fi + 1].to(models.vae_encoder.dtype)  # [1, 1, 3, H, W]
        first_latent, _ = models.vae_encoder.encode_stream(first_pixels)
        return torch.cat([first_latent.to(self.all_latents.dtype), tail], dim=1)

    def plan_block_context(self, models) -> Tuple[Optional[torch.Tensor], int]:
        """(clean context latents or None, model input start frame) for this
        block's KV recompute (release_server.py:588-633)."""
        if self.block_idx == 0:
            return None, self.current_start_frame
        k = self.params.kv_cache_num_frames
        return self.get_clean_context_frames(models), min(self.current_start_frame, k)

    def block_step(self, models, steps: Tuple[float, ...],
                   clean_context: Optional[torch.Tensor], noisy: torch.Tensor,
                   current_start: int) -> torch.Tensor:
        """Reset the KV cache, prefill it from the clean context, denoise the
        block; returns its clean latents x0 [1, nfpb, 16, h, w]."""
        pipeline = models.pipeline
        gen = models.transformer
        kvc.reset_kv_cache(pipeline.kv_cache)
        if clean_context is not None:
            wan_dit.context_prefill(
                gen.cfg, gen.params, clean_context, gen.rope, pipeline.crossattn_cache,
                pipeline.kv_cache, block_tokens=self.frame_seq_length * self.num_frame_per_block,
                layers=gen.layers)
        denoise = gen.make_denoise_block_fn(steps, self._max_attn(), schedule=self.schedule)
        x0, pipeline.kv_cache = denoise(pipeline.kv_cache, pipeline.crossattn_cache,
                                        noisy, current_start, self.noise_fn)
        return x0

    def generate_block_internal(self, models) -> Optional[torch.Tensor]:
        """The per-block hot loop (release_server.py:635-736)."""
        idx = self.block_idx
        if idx >= self.num_blocks:
            return None
        nfpb = self.num_frame_per_block
        if self.current_prompt_embeds is None:
            cond = models.text_encoder(text_prompts=[self.params.prompt])
            self.current_prompt_embeds = cond["prompt_embeds"].to(self.dtype)
            models.pipeline._initialize_crossattn_cache(self.current_prompt_embeds)
        if self.current_start_frame + nfpb > self.all_latents.shape[1]:
            return None
        clean_context, model_input_start_frame = self.plan_block_context(models)
        csf = self.current_start_frame
        noisy_input = self.noise[:, csf:csf + nfpb]

        if self.interpolated_prompt_embeds:
            self.current_prompt_embeds = self.interpolated_prompt_embeds.pop(0).to(self.dtype)
            models.pipeline._initialize_crossattn_cache(self.current_prompt_embeds)

        steps = tuple(float(t) for t in self.denoising_step_list)
        x0 = self.block_step(models, steps, clean_context, noisy_input,
                             model_input_start_frame * self.frame_seq_length)
        self.all_latents[:, csf:csf + nfpb] = x0

        # stream the decode per latent frame: the block's first pixel frames
        # reach the client before the rest of the block is decoded
        vae = models.vae_decoder
        drop = 3 if idx == 0 else 0
        parts = []
        for i in range(x0.shape[1]):
            px_i, self.decode_vae_cache = vae.decode_block(
                x0[:, i:i + 1].to(vae.dtype), self.decode_vae_cache)
            for fi in range(px_i.shape[1]):
                self.frame_context_cache.append((px_i, fi))
            out_i = px_i[:, drop:]
            drop = max(0, drop - px_i.shape[1])
            parts.append(out_i)
            if out_i.shape[1]:
                self.frame_callback(out_i, [], None)
                self.total_frames_sent += out_i.shape[1]
        self.current_start_frame += nfpb
        self.block_idx += 1
        return torch.cat(parts, dim=1)

    def generate_block(self, models):
        out = self.generate_block_internal(models)
        if out is None:
            raise asyncio.CancelledError()
        return out

    def __hash__(self):
        return id(self)
