"""Model loading for the port's server (port of realtime_video_tpu/serving/models.py).

No checkpoint loader is ported yet, so `load_all` random-initialises the DiT
named by `model_name` and the Wan 2.1 VAE from a seed, directly on `device`,
and serves the fixed-embedding text encoder. A config that asks for what is
not ported (a checkpoint, the int8 tier, TAEHV) is refused.
"""
from __future__ import annotations

import logging
import time

import torch

from realtime_video_tpu_torch.config import VAE_CONFIGS, WAN_CONFIGS
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.models.text_encoder import StaticTextEncoder
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline

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
        "enable_int8": bool(config.get("enable_int8", False)),
        "enable_int8_dit": bool(config.get("enable_int8_dit", False)),
        "use_taehv": bool(config.get("use_taehv", False)),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"server config asks for what the PyTorch port does not have yet: "
            f"{', '.join(bad)} (random-init bf16 text-to-video only)")


def load_all(config, device, seed: int = 0) -> Models:
    """Random-init DiT (config["model_name"]) and Wan 2.1 VAE in bf16 on
    `device`, from `seed`; the static text encoder's [1, 512, text_dim]
    embedding is drawn from the same seed."""
    _check_config(config)
    t0 = time.time()
    device = torch.device(device)
    name = config.get("model_name", "t2v-1.3B")
    transformer = WanDiffusion(cfg=WAN_CONFIGS[name],
                               timestep_shift=config.get("timestep_shift", 5.0),
                               device=device, dtype=torch.bfloat16, seed=seed)
    vae = VAEWrapper(cfg=VAE_CONFIGS["wan2.1"], device=device, dtype=torch.bfloat16,
                     seed=seed + 1)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    emb = torch.randn((1, transformer.cfg.text_len, transformer.cfg.text_dim),
                      generator=gen, dtype=torch.float32, device=device)
    text_encoder = StaticTextEncoder(emb.to(torch.bfloat16))
    pipeline = CausalInferencePipeline(config, transformer)
    log.info("All models loaded in %.2fs", time.time() - t0)
    return Models(text_encoder, transformer, pipeline, vae, vae)
