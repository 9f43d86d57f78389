"""The VAE's entry points (port of realtime_video_tpu/models/vae_wrapper.py):
the whole-clip pair `encode_to_latent` / `decode_to_pixel` of the offline
sampler, and the streaming pair `decode_block` / `encode_stream` of the
serving loop.

Public layout as in the JAX package: [B, T, C, H, W], pixels in [-1, 1].
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from realtime_video_tpu_torch.config import MODEL_FOLDER, VAE_CONFIGS, VAEConfig
from realtime_video_tpu_torch.models import vae as vae_mod
from realtime_video_tpu_torch.utils.device import resolve_device


class VAEWrapper:
    """Holds (cfg, params). Without `params` it loads `checkpoint_path` (the
    reference's Wan2.1_VAE.pth) when given, else random-initialises them from
    `seed`, on `device` (default: the CUDA card; pass device="cpu" for the
    CPU); with them, it runs where they lie, bf16 or int8 tier alike."""

    def __init__(self, cfg: Optional[VAEConfig] = None, params=None, device=None,
                 dtype=torch.bfloat16, seed: int = 0, checkpoint_path: Optional[str] = None):
        if cfg is None:
            cfg = VAE_CONFIGS["wan2.1"]
        if params is None:
            device = resolve_device(device)
            if checkpoint_path:
                from realtime_video_tpu_torch.utils.checkpoint import load_vae

                cfg, params = load_vae(checkpoint_path, cfg, dtype, device)
            else:
                gen = torch.Generator(device=device).manual_seed(seed)
                params = vae_mod.init_vae_params(cfg, gen, device, dtype)
        self.cfg = cfg
        self.params = params
        self.dtype = params["conv2"]["w"].dtype
        self.device = params["conv2"]["w"].device

    @classmethod
    def from_model_folder(cls, dtype=torch.bfloat16, device=None, seed: int = 0) -> "VAEWrapper":
        """The Wan 2.1 VAE from MODEL_FOLDER's Wan2.1_VAE.pth when it exists,
        else random-initialised from `seed`."""
        ckpt = os.path.join(MODEL_FOLDER, "Wan2.1-T2V-1.3B", "Wan2.1_VAE.pth")
        return cls(checkpoint_path=ckpt if os.path.exists(ckpt) else None, dtype=dtype,
                   device=device, seed=seed)

    def encode_to_latent(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, T, 3, H, W] in [-1, 1] -> [B, Tz, z, h, w] normalised latents,
        each clip encoded fresh (chunks 1, 4, 4, ...), in the wrapper's dtype."""
        return torch.cat([self.encode_stream(p[None].to(self.dtype))[0] for p in pixels])

    def decode_to_pixel(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, Tz, z, h, w] -> [B, 1 + 4 (Tz - 1), 3, H, W] f32 in [-1, 1]: a
        fresh whole-clip decode of each clip, in the wrapper's dtype."""
        return torch.cat([self.decode_block(z[None].to(self.dtype))[0] for z in latents])

    def decode_block(self, latents: torch.Tensor,
                     cache: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
        """[B, Tz, z, h, w] + cache -> ([B, T, 3, H, W] f32, cache). The first
        call (cache None) yields 1 + 4(Tz-1) frames, later calls 4*Tz."""
        z = latents.permute(0, 1, 3, 4, 2)
        out, cache = vae_mod.decode_chunks(self.cfg, self.params, z, cache,
                                           first=cache is None)
        return out.permute(0, 1, 4, 2, 3), cache

    def encode_stream(self, pixels: torch.Tensor,
                      cache: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
        """[B, T, C, H, W] + cache -> ([B, Tz, z, h, w], cache). cache None
        expects T = 1 + 4k (chunks 1, 4, 4, ...); a warm cache expects T = 4k."""
        video = pixels.permute(0, 1, 3, 4, 2)
        z, cache = vae_mod.encode_chunks(self.cfg, self.params, video, cache,
                                         stream=cache is not None)
        return z.permute(0, 1, 4, 2, 3), cache
