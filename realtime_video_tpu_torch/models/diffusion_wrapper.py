"""Diffusion model wrapper (port of realtime_video_tpu/models/diffusion_wrapper.py):
one forward returning (flow_pred, pred_x0, kv) and the per-block denoise loop.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from realtime_video_tpu_torch.config import WAN_CONFIGS, WanModelConfig
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.rope import RopeTables
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule
from realtime_video_tpu_torch.utils.device import resolve_device

#: draws renoise for one denoising step: (shape, dtype, device) -> tensor
NoiseFn = Callable[[Tuple[int, ...], torch.dtype, torch.device], torch.Tensor]


def generator_noise(generator: torch.Generator) -> NoiseFn:
    """Standard-normal noise from `generator`, drawn in f32 and cast."""

    def draw(shape, dtype, device):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device).to(dtype)

    return draw


class WanDiffusion:
    """Holds (cfg, params, schedule, rope) on one device. Without `params` it
    loads `checkpoint_path` (a reference state dict; the config is detected
    from it) when that file exists, else random-initialises them from `seed`,
    on `device` (default: the CUDA card; pass device="cpu" for the CPU); with
    them, it runs where they lie."""

    def __init__(self, cfg: Optional[WanModelConfig] = None, params=None,
                 model_name: str = "t2v-1.3B", timestep_shift: float = 5.0,
                 device=None, dtype=torch.bfloat16, seed: int = 0,
                 fuse_qkv: bool = True, checkpoint_path: Optional[str] = None):
        if params is None and checkpoint_path and os.path.exists(checkpoint_path):
            from realtime_video_tpu_torch.utils.checkpoint import load_wan_dit

            cfg, params = load_wan_dit(checkpoint_path, dtype, resolve_device(device))
        if cfg is None:
            cfg = WAN_CONFIGS[model_name]
        if params is None:
            device = resolve_device(device)
            gen = torch.Generator(device=device).manual_seed(seed)
            params = wan_dit.init_wan_params(cfg, gen, device, dtype)
        if fuse_qkv:
            params = wan_dit.fuse_qkv_params(params)
        self.cfg = cfg
        self.params = params
        self.device = params["patch_embedding"]["w"].device
        self.dtype = params["patch_embedding"]["w"].dtype
        self.layers = wan_dit.layer_params(params, cfg.num_layers)
        self.schedule = FlowMatchSchedule.create(
            shift=timestep_shift, sigma_min=0.0, extra_one_step=True, device=self.device)
        self.rope = RopeTables.create(cfg.head_dim, device=self.device)

    def calibrate_act_scales(self, steps: Sequence[float], lat_h: int = 16, lat_w: int = 16,
                             kv_frames: int = 6, nfpb: int = 3,
                             noisy: Optional[Sequence[torch.Tensor]] = None,
                             context: Optional[torch.Tensor] = None,
                             seed: int = 0) -> Dict[Tuple[str, str], torch.Tensor]:
        """Per-(site, layer) activation maxima over eager float decode forwards
        at each denoise timestep plus the t=0 context refresh, the KV cache
        carried from one to the next (diffusion_wrapper.py:84-172 of the JAX
        package, its eager form). Feed the result to
        wan_dit.quantize_wan_linears(act_scales=); call it before quantising.

        `noisy` (one [1, nfpb, in_dim, lat_h, lat_w] latent per timestep) and
        `context` ([1, T, text_dim]) default to normal draws from `seed`."""
        cfg = self.cfg
        sa = self.params["blocks"]["self_attn"]
        if "w" not in sa.get("qkv", sa.get("q", {})):
            raise ValueError("calibrate on float params, before quantising")
        fsl = cfg.frame_seq_length(lat_h, lat_w)
        cache_size = kv_frames * fsl
        ts = [float(t) for t in steps]
        if not ts or ts[-1] != 0.0:  # cover the t=0 refresh pass once
            ts.append(0.0)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if noisy is None:
            noisy = [torch.randn((1, nfpb, cfg.in_dim, lat_h, lat_w), generator=gen,
                                 device=self.device) for _ in ts]
        if context is None:
            context = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                                  device=self.device)
        if len(noisy) != len(ts):
            raise ValueError(f"{len(noisy)} noisy latents for {len(ts)} timesteps")
        cross = self.compute_crossattn_cache(context.to(self.device, self.dtype))
        # a bf16 cache whatever the params' dtype, as the JAX method's default
        kv = kvc.init_kv_cache(cfg.num_layers, 1, cache_size, cfg.num_heads, cfg.head_dim,
                               torch.bfloat16, self.device)
        records: list = []
        for x, t in zip(noisy, ts):
            tt = torch.full((1, nfpb), t, dtype=torch.float32, device=self.device)
            _, _, kv = self.forward(x.to(self.device, self.dtype), cross, tt, kv,
                                    (kv_frames - nfpb) * fsl, "decode", cache_size,
                                    act_calib=records)
        return wan_dit.calibrate_wan_act_scales(records, self.params["blocks"], cfg.num_layers)

    def compute_crossattn_cache(self, prompt_embeds: torch.Tensor) -> Dict[str, torch.Tensor]:
        return wan_dit.compute_crossattn_cache(self.cfg, self.params, prompt_embeds)

    def forward(self, noisy: torch.Tensor, crossattn_cache, timestep: torch.Tensor,
                kv_cache: Optional[Dict] = None, current_start: int = 0, mode: str = "decode",
                max_attention_size: Optional[int] = None,
                schedule: Optional[FlowMatchSchedule] = None,
                act_calib: Optional[list] = None,
                attn_mask: Optional[torch.Tensor] = None):
        """Returns (flow_pred, pred_x0, kv_cache) — WanDiffusionWrapper.forward
        (wan_wrapper.py:230-301). Train mode takes no cache (kv_cache None,
        returned as None) and an optional dense `attn_mask` [L, L]."""
        t = timestep.to(torch.float32)
        if max_attention_size is None:
            fsl = self.cfg.frame_seq_length(noisy.shape[-2], noisy.shape[-1])
            max_attention_size = self.cfg.max_attention_size(fsl)
        flow, kv = wan_dit.dit_forward(
            self.cfg, self.params, noisy, t, self.rope, crossattn_cache, mode=mode,
            kv_cache=kv_cache, current_start=current_start,
            max_attention_size=max_attention_size, layers=self.layers,
            act_calib=act_calib, attn_mask=attn_mask)
        x0 = (schedule or self.schedule).flow_to_x0(flow, noisy, t)
        return flow, x0, kv

    def make_denoise_block_fn(self, steps: Tuple[float, ...], max_attention_size: int,
                              schedule: Optional[FlowMatchSchedule] = None,
                              refresh_t: Optional[float] = None):
        """The per-block denoise loop (release_server.py:669-706): a forward at
        each step's timestep, then x0 renoised to the next step's timestep.
        With `refresh_t`, one more decode forward of the clean x0 at that
        timestep rewrites the block's K/V (the offline sampler's clean-context
        cache refresh, causal_inference.py:227-236); serving passes None.

        Returns fn(kv, cross, noisy, current_start, noise_fn) -> (x0, kv).
        noise_fn is called once per step, the last included (its draw is
        discarded there), as the JAX loop splits its key every step."""
        schedule = schedule or self.schedule
        steps = tuple(float(s) for s in steps)
        nexts = steps[1:] + (0.0,)

        def fn(kv, cross, noisy, current_start: int, noise_fn: NoiseFn):
            b, f = noisy.shape[:2]
            x0 = noisy
            for i, (t_val, t_next) in enumerate(zip(steps, nexts)):
                t = torch.full((b, f), t_val, dtype=torch.float32, device=noisy.device)
                _, x0, kv = self.forward(noisy, cross, t, kv, current_start, "decode",
                                         max_attention_size, schedule)
                nz = noise_fn(tuple(x0.shape), x0.dtype, x0.device)
                if i < len(steps) - 1:
                    tn = torch.full((b, f), t_next, dtype=torch.float32,
                                    device=noisy.device)
                    noisy = schedule.add_noise(x0, nz, tn)
            if refresh_t is not None:
                t = torch.full((b, f), float(refresh_t), dtype=torch.float32,
                               device=noisy.device)
                _, _, kv = self.forward(x0, cross, t, kv, current_start, "decode",
                                        max_attention_size, schedule)
            return x0, kv

        return fn
