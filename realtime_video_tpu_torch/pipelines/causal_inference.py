"""Few-step block-causal sampler with a KV cache (port of
realtime_video_tpu/pipelines/causal_inference.py, after the reference's
`CausalInferencePipeline`, pipeline/causal_inference.py:9-339).

`inference` runs the offline loop: optional prefill of the cache from
`initial_latent` (i2v, video extension), then per block the few-step denoise
over `denoising_step_list` with renoise between steps and a clean-context
cache refresh at `context_noise`, then one VAE decode of the whole clip. The
serving session uses the cache state and size helpers, and sets
`local_attn_size` per session; `inference` always attends over the
configured window (21 frames, 32760 tokens at 832x480, for the released
models), whatever a session left there.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import (
    NoiseFn,
    WanDiffusion,
    generator_noise,
)
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.scheduler import warp_denoising_steps


class CausalInferencePipeline:
    def __init__(self, config, generator: WanDiffusion, text_encoder=None, vae=None):
        self.generator = generator
        self.text_encoder = text_encoder
        self.vae = vae
        steps = list(config.get("denoising_step_list", [1000, 937, 833, 625, 0]))
        if config.get("warp_denoising_step", False):
            steps = warp_denoising_steps(generator.schedule.timesteps, steps).tolist()
        self.denoising_step_list = tuple(float(s) for s in steps)
        self.num_frame_per_block = config.get("num_frame_per_block", 1)
        self.independent_first_frame = config.get("independent_first_frame", False)
        self.context_noise = float(config.get("context_noise", 0))
        #: cache length in frames (-1: the global 21-frame window); the server
        #: sets it per session to kv frames + one block
        self.local_attn_size = generator.cfg.local_attn_size
        self.kv_cache = None
        self.crossattn_cache = None
        self.last_profile: Optional[dict] = None

    def frame_seq_length(self, latent_h: int, latent_w: int) -> int:
        return self.generator.cfg.frame_seq_length(latent_h, latent_w)

    def kv_cache_size(self, frame_seqlen: int) -> int:
        if self.local_attn_size != -1:
            return self.local_attn_size * frame_seqlen
        return 21 * frame_seqlen  # 32760 at 832x480 (causal_inference.py:289)

    def max_attention_size(self, frame_seqlen: int) -> int:
        return self.generator.cfg.max_attention_size(frame_seqlen)

    def _initialize_kv_cache(self, batch_size: int, frame_seqlen: int,
                             dtype=torch.bfloat16, cache_size: Optional[int] = None) -> None:
        """Zero the cache in place when its shape fits, else allocate it;
        `cache_size` tokens (default: `kv_cache_size`)."""
        if cache_size is None:
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

    def _prefill(self, latents: torch.Tensor, current_start: int, max_attn: int) -> None:
        """Write clean context latents into the cache: a decode-mode forward
        at t = 0 (causal_inference.py:137-170)."""
        t = torch.zeros(latents.shape[:2], dtype=torch.float32, device=latents.device)
        _, _, self.kv_cache = self.generator.forward(
            latents, self.crossattn_cache, t, self.kv_cache, current_start, "decode", max_attn)

    def inference(self, noise: torch.Tensor, text_prompts: Optional[List[str]] = None,
                  initial_latent: Optional[torch.Tensor] = None, return_latents: bool = False,
                  profile: bool = False, prompt_embeds: Optional[torch.Tensor] = None,
                  seed: int = 0, low_memory: bool = False,
                  noise_fn: Optional[NoiseFn] = None):
        """Generate latents for `noise` [B, F, C, h, w] (after `initial_latent`
        [B, Fi, C, h, w] when given, which passes through unchanged) and decode
        them with the pipeline's VAE: video [B, T, 3, H, W] in [0, 1], or None
        without a VAE; (video, latents) with `return_latents`. Latents and the
        KV cache are in the DiT's dtype.

        Renoise draws come from `noise_fn` (default: a torch.Generator on the
        DiT's device seeded with `seed`), one per denoising step in block
        order. `low_memory` is accepted for API parity. `profile` prints the
        time of each phase and block, each ended by a device sync, and keeps
        them (ms) in `last_profile`."""
        del low_memory
        gen = self.generator
        nfpb = self.num_frame_per_block
        batch_size, num_frames, _, h, w = noise.shape
        if not self.independent_first_frame or initial_latent is not None:
            if num_frames % nfpb:
                raise ValueError(f"{num_frames} noise frames: not a multiple of {nfpb}")
            num_blocks = num_frames // nfpb
        else:
            if (num_frames - 1) % nfpb:
                raise ValueError(f"{num_frames} noise frames: not 1 + a multiple of {nfpb}")
            num_blocks = (num_frames - 1) // nfpb
        num_input_frames = initial_latent.shape[1] if initial_latent is not None else 0
        num_output_frames = num_frames + num_input_frames

        if prompt_embeds is None:
            if self.text_encoder is None or text_prompts is None:
                raise ValueError("pass prompt_embeds, or text_prompts with a text encoder")
            prompt_embeds = self.text_encoder(text_prompts=text_prompts)["prompt_embeds"]
        # bf16 embeddings, as the JAX pipeline casts them, in the DiT's dtype
        prompt_embeds = prompt_embeds.to(gen.device, torch.bfloat16).to(gen.dtype)
        noise = noise.to(gen.device, gen.dtype)
        if noise_fn is None:
            noise_fn = generator_noise(torch.Generator(device=gen.device).manual_seed(seed))

        def sync():
            if profile and gen.device.type == "cuda":
                torch.cuda.synchronize(gen.device)

        fsl = self.frame_seq_length(h, w)
        max_attn = self.max_attention_size(fsl)
        t_init0 = time.perf_counter()
        self._initialize_kv_cache(batch_size, fsl, gen.dtype, cache_size=max_attn)
        self._initialize_crossattn_cache(prompt_embeds)

        outputs = []
        current_start_frame = 0
        if initial_latent is not None:
            initial_latent = initial_latent.to(gen.device, gen.dtype)
            if self.independent_first_frame:
                if (num_input_frames - 1) % nfpb:
                    raise ValueError(f"{num_input_frames} initial latents: not 1 + a "
                                     f"multiple of {nfpb}")
                num_input_blocks = (num_input_frames - 1) // nfpb
                outputs.append(initial_latent[:, :1])
                self._prefill(initial_latent[:, :1], 0, max_attn)
                current_start_frame += 1
            else:
                if num_input_frames % nfpb:
                    raise ValueError(f"{num_input_frames} initial latents: not a multiple "
                                     f"of {nfpb}")
                num_input_blocks = num_input_frames // nfpb
            for _ in range(num_input_blocks):
                ref = initial_latent[:, current_start_frame:current_start_frame + nfpb]
                outputs.append(ref)
                self._prefill(ref, current_start_frame * fsl, max_attn)
                current_start_frame += nfpb
        sync()
        t_init = time.perf_counter() - t_init0

        block_fn = gen.make_denoise_block_fn(self.denoising_step_list, max_attn,
                                             refresh_t=self.context_noise)
        all_num_frames = [nfpb] * num_blocks
        if self.independent_first_frame and initial_latent is None:
            all_num_frames = [1] + all_num_frames
        block_times = []
        t_diff0 = time.perf_counter()
        for current_num_frames in all_num_frames:
            tb0 = time.perf_counter()
            lo = current_start_frame - num_input_frames
            x0, self.kv_cache = block_fn(self.kv_cache, self.crossattn_cache,
                                         noise[:, lo:lo + current_num_frames],
                                         current_start_frame * fsl, noise_fn)
            outputs.append(x0)
            current_start_frame += current_num_frames
            sync()
            block_times.append(time.perf_counter() - tb0)
        latents = torch.cat(outputs, dim=1)
        if latents.shape[1] != num_output_frames:
            raise RuntimeError(f"{latents.shape[1]} latent frames, expected {num_output_frames}")
        t_diff = time.perf_counter() - t_diff0

        t_vae0 = time.perf_counter()
        video = None
        if self.vae is not None:
            video = torch.clamp(self.vae.decode_to_pixel(latents) * 0.5 + 0.5, 0.0, 1.0)
        sync()
        if profile:
            t_vae = time.perf_counter() - t_vae0
            total = t_init + t_diff + t_vae
            print("Profiling results:")
            print(f"  - Initialization/caching time: {t_init * 1e3:.2f} ms "
                  f"({100 * t_init / total:.2f}%)")
            print(f"  - Diffusion generation time: {t_diff * 1e3:.2f} ms "
                  f"({100 * t_diff / total:.2f}%)")
            for i, bt in enumerate(block_times):
                print(f"    - Block {i} generation time: {bt * 1e3:.2f} ms")
            print(f"  - VAE decoding time: {t_vae * 1e3:.2f} ms ({100 * t_vae / total:.2f}%)")
            print(f"  - Total time: {total * 1e3:.2f} ms")
            self.last_profile = dict(init_ms=t_init * 1e3, diffusion_ms=t_diff * 1e3,
                                     block_ms=[t * 1e3 for t in block_times],
                                     vae_ms=t_vae * 1e3)
        if return_latents:
            return video, latents
        return video
