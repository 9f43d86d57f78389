"""Model loading for the port's server (port of realtime_video_tpu/serving/models.py).

No checkpoint loader is ported yet, so `load_all` random-initialises the DiT
named by `model_name` and the Wan 2.1 VAE from a seed, directly on `device`,
and serves the fixed-embedding text encoder. A config that asks for what is
not ported (a checkpoint, TAEHV) is refused.

The int8 tier follows the JAX loaders' steps on the device itself:
`enable_int8_dit` (default: `enable_int8`) calibrates the DiT's block linears
on the serving denoise schedule and quantises them; `enable_int8` calibrates
and quantises the VAE's 3x3 convs, decoder and encoder both. With
`int8_static_scales` (default on) the activation scales are the calibrated
static ones, else each call takes its own amax. The JAX loaders' on-disk
cache of quantised trees is not ported: calibrating and quantising on the
card takes seconds.
"""
from __future__ import annotations

import logging
import time

import torch

from realtime_video_tpu_torch.config import VAE_CONFIGS, WAN_CONFIGS
from realtime_video_tpu_torch.models import vae as vae_mod
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.models.text_encoder import StaticTextEncoder
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule, get_denoising_schedule

log = logging.getLogger(__name__)


class Models:
    def __init__(self, text_encoder, transformer, pipeline, vae_encoder, vae_decoder):
        self.text_encoder = text_encoder
        self.transformer: WanDiffusion = transformer
        self.pipeline: CausalInferencePipeline = pipeline
        # one VAEWrapper serves both roles; two attributes for API parity
        self.vae_encoder: VAEWrapper = vae_encoder
        self.vae_decoder: VAEWrapper = vae_decoder


def _check_config(config) -> None:
    unsupported = {
        "checkpoint_path": bool(config.get("checkpoint_path", "")),
        "use_taehv": bool(config.get("use_taehv", False)),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"server config asks for what the PyTorch port does not have yet: "
            f"{', '.join(bad)} (random-init text-to-video only)")


def _denoise_steps(config, shift) -> tuple:
    """The serving denoising schedule, which drives the DiT's int8 calibration."""
    schedule = FlowMatchSchedule.create(shift=float(shift), sigma_min=0.0,
                                        extra_one_step=True)
    return tuple(float(t) for t in get_denoising_schedule(
        schedule.zero_padded_timesteps(), 1.0,
        int(config.get("num_denoising_steps", 5) or 5)))


def load_transformer(config, device, seed: int = 0) -> WanDiffusion:
    """Random-init DiT in bf16 on `device`; on the int8 tier, calibrated (on
    the serving schedule, when scales are static) and quantised there."""
    shift = config.get("timestep_shift", 5.0)
    cfg = WAN_CONFIGS[config.get("model_name", "t2v-1.3B")]
    transformer = WanDiffusion(cfg=cfg, timestep_shift=shift, device=device,
                               dtype=torch.bfloat16, seed=seed)
    if not config.get("enable_int8_dit", config.get("enable_int8", False)):
        return transformer
    static = bool(config.get("int8_static_scales", True))
    act_scales = (transformer.calibrate_act_scales(_denoise_steps(config, shift), seed=seed)
                  if static else None)
    params = wan_dit.quantize_wan_linears(transformer.params, act_scales=act_scales)
    log.info("DiT linears quantised to int8 (static scales: %s)", static)
    return WanDiffusion(cfg=cfg, params=params, timestep_shift=shift)


def load_vae(config, device, seed: int = 0) -> VAEWrapper:
    """Random-init Wan 2.1 VAE in bf16 on `device`; with `enable_int8`, its 3x3
    convs calibrated (static scales: a float decode of 2 latents (1, 2, 8, 8,
    16) and an encode of one (1, 1, 64, 64, 3) frame, the JAX loader's
    shapes) and quantised there, the encoder's included."""
    vae = VAEWrapper(cfg=VAE_CONFIGS["wan2.1"], device=device, dtype=torch.bfloat16,
                     seed=seed)
    if not config.get("enable_int8", False):
        return vae
    static = bool(config.get("int8_static_scales", True))
    act_scales = None
    if static:
        gen = torch.Generator(device=device).manual_seed(seed)
        zc = torch.randn((1, 2, 8, 8, vae.cfg.z_dim), generator=gen, device=device)
        pxc = torch.rand((1, 1, 64, 64, 3), generator=gen, device=device) * 2.0 - 1.0
        act_scales = vae_mod.calibrate_vae_act_scales(
            vae.cfg, vae.params, zc.to(torch.bfloat16), pxc.to(torch.bfloat16))
    params = vae_mod.quantize_vae_params(vae.params, act_scales=act_scales)
    log.info("VAE convs quantised to int8 (static scales: %s)", static)
    return VAEWrapper(cfg=vae.cfg, params=params)


def load_all(config, device, seed: int = 0) -> Models:
    """DiT (config["model_name"]) and Wan 2.1 VAE on `device`, random weights
    from `seed`, in the tier the config asks for; the static text encoder's
    [1, 512, text_dim] embedding is drawn from the same seed."""
    _check_config(config)
    t0 = time.time()
    device = torch.device(device)
    transformer = load_transformer(config, device, seed)
    vae = load_vae(config, device, seed + 1)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    emb = torch.randn((1, transformer.cfg.text_len, transformer.cfg.text_dim),
                      generator=gen, dtype=torch.float32, device=device)
    text_encoder = StaticTextEncoder(emb.to(torch.bfloat16))
    pipeline = CausalInferencePipeline(config, transformer)
    log.info("All models loaded in %.2fs", time.time() - t0)
    return Models(text_encoder, transformer, pipeline, vae, vae)
