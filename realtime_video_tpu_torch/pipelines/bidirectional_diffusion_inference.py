"""The 50-step CFG teacher over a whole clip (port of
realtime_video_tpu/pipelines/bidirectional_diffusion_inference.py, after the
reference's `BidirectionalDiffusionInferencePipeline` and Wan 2.1's
text2video.py).

Every step runs a conditional and an unconditional train-mode forward over
all of the clip's tokens, with no mask and no cache (32760 tokens at 81
frames of 832x480, each attending to all of them: the attention kernel's
unmasked window on a card), guided as flow_u + g * (flow_c - flow_u), and
one solver (UniPC, or DPM++ on the explicit `get_sampling_sigmas` ladder)
steps the latents. `WanI2V` runs its loop here too, with the CLIP
features in both cross caches and its 20 conditioning channels beside the
latents. The pipeline runs on the generator's device.

`sp_mesh` (a one-axis DeviceMesh over the whole world, one rank a card)
shards the teacher's tokens over its ranks with hybrid USP attention, as
the reference runs its teacher under xDiT USP (text2video.py:87-97): the
Ulysses degree is the largest divisor of the world that divides the heads,
and the ring covers the rest (`_sp_attention`, built once with its process
groups when the pipeline is made, so a loop over clips makes no new group).
Every rank runs the whole loop on the same noise and gets the whole flow
back from each forward (`wan_dit.dit_forward(sp_attn=)`), so the solver's
state stays replicated.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.parallel import mesh as mesh_mod
from realtime_video_tpu_torch.parallel import sequence
from realtime_video_tpu_torch.pipelines.causal_diffusion_inference import (
    ProfileClock,
    decode_video,
    prompt_pair,
)
from realtime_video_tpu_torch.solvers import make_solver


class BidirectionalDiffusionInferencePipeline:
    def __init__(self, config, generator: WanDiffusion, text_encoder=None, vae=None,
                 sp_mesh=None):
        self.generator = generator
        self.text_encoder = text_encoder
        self.vae = vae
        self.guidance_scale = float(config.get("guidance_scale", 5.0))
        self.sample_solver = config.get("sample_solver", "unipc")
        self.sampling_steps = int(config.get("sampling_steps", 50))
        self.shift = float(config.get("timestep_shift", 5.0))
        self.sp_mesh = sp_mesh
        self.sp_attn, self.usp_mesh = (None, None) if sp_mesh is None else self._sp_attention()
        self.last_profile: Optional[dict] = None

    def _forward(self, cross, x: torch.Tensor, t: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if y is not None:
            x = torch.cat([x, y], dim=2)  # i2v: 16 + 20 = 36 channels
        flow, _, _ = self.generator.forward(x, cross, t, mode="train", sp_attn=self.sp_attn)
        return flow

    def _sp_attention(self):
        """(USP attention over `sp_mesh`, the (ring, Ulysses) mesh it runs
        on): Ulysses degree the largest divisor of the world that divides the
        heads, the ring over the rest (xdit_context_parallel.py:179-184)."""
        n = self.sp_mesh.size()
        heads = self.generator.cfg.num_heads
        uly = max(d for d in range(1, n + 1) if n % d == 0 and heads % d == 0)
        mesh2 = mesh_mod.make_mesh({"sp_r": n // uly, "sp_u": uly},
                                   self.sp_mesh.device_type)
        return sequence.make_usp_attention(mesh2, "sp_u", "sp_r"), mesh2

    def inference(self, noise: torch.Tensor, text_prompts: Optional[List[str]] = None,
                  prompt_embeds: Optional[torch.Tensor] = None,
                  neg_prompt_embeds: Optional[torch.Tensor] = None,
                  return_latents: bool = False, profile: bool = False,
                  clip_fea: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                  solver=None):
        """Sample the clip `noise` [B, F, C, h, w] and decode it: video
        [B, T, 3, H, W] in [0, 1] (None without a VAE); (video, latents)
        with `return_latents`. An i2v model takes its CLIP features
        `clip_fea` (into both cross caches) and its conditioning channels
        `y` [B, F, 20, h, w] (beside the latents in every forward). `solver`
        is a solver with its timesteps set, else one from the config.
        `profile` syncs the device after the cross caches, after every step
        and after the decode and keeps the times (ms) in `last_profile`."""
        gen = self.generator
        b, f = noise.shape[:2]
        clock = ProfileClock(gen.device, profile)
        cond, uncond = prompt_pair(self, b, text_prompts, prompt_embeds, neg_prompt_embeds)
        cross_pos = gen.compute_crossattn_cache(cond, clip_fea)
        cross_neg = gen.compute_crossattn_cache(uncond, clip_fea)
        cross_ms = clock.lap()
        if solver is None:
            solver = make_solver(self.sample_solver, self.sampling_steps, self.shift)

        latent = noise.to(gen.device, gen.dtype)
        step_ms = []
        for t_val in solver.timesteps:
            # one timestep for every frame (wan_wrapper.py:245-248)
            t = torch.full((b, f), float(t_val), dtype=torch.float32, device=gen.device)
            flow_c = self._forward(cross_pos, latent, t, y)
            flow_u = self._forward(cross_neg, latent, t, y)
            flow = flow_u + self.guidance_scale * (flow_c - flow_u)
            latent = solver.step(flow, float(t_val), latent)
            step_ms.append(clock.lap())

        video = decode_video(self.vae, latent)
        decode_ms = clock.lap()
        if profile:
            self.last_profile = dict(cross_ms=cross_ms, step_ms=step_ms, decode_ms=decode_ms)
        if return_latents:
            return video, latent
        return video
