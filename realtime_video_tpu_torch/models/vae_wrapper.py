"""The VAE's entry points (port of realtime_video_tpu/models/vae_wrapper.py):
the whole-clip pair `encode_to_latent` / `decode_to_pixel` of the offline
sampler, and the streaming pair `decode_block` / `encode_stream` of the
serving loop.

Public layout as in the JAX package: [B, T, C, H, W], pixels in [-1, 1].

Placement, as the JAX wrapper's: `device=` pins the VAE to a card of its
own, so that a block's decode can run there while the DiT's card takes the
next block; `mesh=` (a list of devices) splits it by image rows over those
devices (`parallel/vae_sp.py`). Decoded pixels stay on the VAE's (first)
device, on their way to the host; encoded latents go to `dit_device`, where
the DiT reads them. Switches read at construction: RTV_VAE_FUSEUP=1 folds
each decoder upsample into its phase conv (`vae.fuse_decoder_upsample`, float
trees only), RTV_VAE_CHUNK the latent frames per decoder pass (default 1).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from realtime_video_tpu_torch.config import MODEL_FOLDER, VAE_CONFIGS, VAEConfig
from realtime_video_tpu_torch.models import vae as vae_mod
from realtime_video_tpu_torch.parallel import vae_sp
from realtime_video_tpu_torch.utils.device import indexed, resolve_device
from realtime_video_tpu_torch.utils import trace
from realtime_video_tpu_torch.utils.qcache import move_tree


def fuseup_enabled() -> bool:
    return os.getenv("RTV_VAE_FUSEUP", "0") in ("1", "true")


class VAEWrapper:
    """Holds (cfg, params). Without `params` it loads `checkpoint_path` (the
    reference's Wan2.1_VAE.pth) when given, else random-initialises them from
    `seed`, on `device` (or the first device of `mesh`; default: the CUDA
    card; pass device="cpu" for the CPU); with them, it runs where they lie,
    or on `device` when one is named, bf16 or int8 tier alike.

    device: pin the VAE (params and compute) to this device.
    mesh: devices to split the VAE over by image rows, shard s on mesh[s]
        (one device may hold several shards); not with `device`. The
        streaming cache is then one tuple per shard, opaque to callers.
    dit_device: where encoded latents go; default, with `device` or `mesh`,
        the current CUDA card (the CPU for a CPU VAE), else where they are.
    """

    def __init__(self, cfg: Optional[VAEConfig] = None, params=None, device=None,
                 dtype=torch.bfloat16, seed: int = 0, checkpoint_path: Optional[str] = None,
                 dit_device=None, mesh: Optional[Sequence] = None):
        if device is not None and mesh is not None:
            raise ValueError("device= and mesh= are exclusive")
        if mesh is not None and not len(mesh):
            raise ValueError("mesh= names no device")
        devices = tuple(indexed(d) for d in mesh) if mesh is not None else None
        if cfg is None:
            cfg = VAE_CONFIGS["wan2.1"]
        if params is None:
            where = resolve_device(devices[0] if devices else device)
            if checkpoint_path:
                from realtime_video_tpu_torch.utils.checkpoint import load_vae

                cfg, params = load_vae(checkpoint_path, cfg, dtype, where)
            else:
                gen = torch.Generator(device=where).manual_seed(seed)
                params = vae_mod.init_vae_params(cfg, gen, where, dtype)
        elif device is not None:
            params = move_tree(params, indexed(device))
        if fuseup_enabled():
            # an exact rewrite (vae.fuse_decoder_upsample); an int8 tree,
            # quantised after its own fold or without one, passes through
            params = vae_mod.fuse_decoder_upsample(params)
        self.cfg = cfg
        self.split = devices is not None
        # one row shard where the params lie, unless split
        self.devices = devices or (params["conv2"]["w"].device,)
        self.shard_params = vae_sp.replicate(params, self.devices)
        self.params = self.shard_params[0]
        self.dtype = self.params["conv2"]["w"].dtype
        self.device = self.params["conv2"]["w"].device
        if dit_device is None and (device is not None or devices):
            dit_device = resolve_device() if self.device.type == "cuda" else self.device
        self.dit_device = None if dit_device is None else indexed(dit_device)
        # latent frames batched through each conv per decoder pass
        self.chunk = int(os.getenv("RTV_VAE_CHUNK", "1"))

    @classmethod
    def from_model_folder(cls, dtype=torch.bfloat16, device=None, seed: int = 0,
                          mesh=None, dit_device=None) -> "VAEWrapper":
        """The Wan 2.1 VAE from MODEL_FOLDER's Wan2.1_VAE.pth when it exists,
        else random-initialised from `seed`."""
        ckpt = os.path.join(MODEL_FOLDER, "Wan2.1-T2V-1.3B", "Wan2.1_VAE.pth")
        return cls(checkpoint_path=ckpt if os.path.exists(ckpt) else None, dtype=dtype,
                   device=device, seed=seed, mesh=mesh, dit_device=dit_device)

    # -- placement ------------------------------------------------------------

    def _to_vae(self, x: torch.Tensor):
        """x [B, T, H, W, C] cut into the VAE's row shards, shard s on
        devices[s] (unsplit: x whole, on the VAE's device)."""
        return vae_sp.split_rows(x, self.devices, axis=2)

    def _shard_caches(self, cache):
        return cache if cache is None or self.split else (cache,)

    def _cache(self, caches):
        """The cache handed back: one tuple per shard when split (opaque to
        callers), else the unsplit VAE's flat tuple."""
        return caches if self.split else caches[0]

    # -- batch API --------------------------------------------------------------

    def encode_to_latent(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, T, 3, H, W] in [-1, 1] -> [B, Tz, z, h, w] normalised latents,
        each clip encoded fresh (chunks 1, 4, 4, ...), in the wrapper's dtype."""
        return torch.cat([self.encode_stream(p[None].to(self.dtype))[0] for p in pixels])

    def decode_to_pixel(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, Tz, z, h, w] -> [B, 1 + 4 (Tz - 1), 3, H, W] f32 in [-1, 1]: a
        fresh whole-clip decode of each clip, in the wrapper's dtype."""
        return torch.cat([self.decode_block(z[None].to(self.dtype))[0] for z in latents])

    # -- streaming API (server hot loop) ----------------------------------------

    def decode_block(self, latents: torch.Tensor,
                     cache: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
        """[B, Tz, z, h, w] + cache -> ([B, T, 3, H, W] f32 on the VAE's
        device, cache). The first call (cache None) yields 1 + 4(Tz-1)
        frames, later calls 4*Tz. Its span: `vae.decode`."""
        with trace.span("vae.decode"):
            outs, caches = vae_mod.decode_rows(
                self.cfg, self.shard_params, self._to_vae(latents.permute(0, 1, 3, 4, 2)),
                self._shard_caches(cache), first=cache is None, chunk=self.chunk)
            out = vae_mod.join_rows(outs, self.device, dim=2)
            return out.permute(0, 1, 4, 2, 3), self._cache(caches)

    def encode_stream(self, pixels: torch.Tensor,
                      cache: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
        """[B, T, C, H, W] + cache -> ([B, Tz, z, h, w] on `dit_device`,
        cache). cache None expects T = 1 + 4k (chunks 1, 4, 4, ...); a warm
        cache expects T = 4k. Its span: `vae.encode`."""
        video = pixels.permute(0, 1, 3, 4, 2)
        if self.split:
            if video.shape[2] % 8:
                raise ValueError(f"pixel height {video.shape[2]} is not a multiple of 8")
            vae_sp.check_rows(video.shape[2] // 8, len(self.devices))
        with trace.span("vae.encode"):
            zs, caches = vae_mod.encode_rows(self.cfg, self.shard_params, self._to_vae(video),
                                             self._shard_caches(cache),
                                             stream=cache is not None)
            z = vae_mod.join_rows(zs, self.dit_device or self.device, dim=2)
            return z.permute(0, 1, 4, 2, 3), self._cache(caches)
