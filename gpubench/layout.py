"""What a configuration file may state about its model's layout, and the
defaults for what it leaves out: the Wan 2.1 t2v layout that every cell had
before a file could state one. No other module of the harness names a VAE
entry, a latent stride or a reference class.

  * `port.vae_name`: the port's `VAE_CONFIGS` entry that the file's `vae`
    section must match (default "wan2.1");
  * `vae.stride`: the VAE's (time, height, width) compression (default
    [4, 8, 8]); the latent's channels are `vae.z_dim`;
  * `reference_modules`: {"dit": "<module>:<class>", "vae": ...}, classes of
    `gpubench/reference/<module>.py` that the check builds (default
    wan_dit:WanDiT, wan_vae:WanVAE);
  * `work`: "<module>:<function>" of `gpubench/<module>.py` that counts a
    warm block's work by family for the rooflines and `block_mfu` (default
    roofline:warm_block_work).

A new layout brings its reference and its count of work as new files and
names them here; no file of the harness is edited for it.
"""
from __future__ import annotations

import importlib
from typing import Tuple

VAE_NAME = "wan2.1"
VAE_STRIDE = (4, 8, 8)
REFERENCE = {"dit": "wan_dit:WanDiT", "vae": "wan_vae:WanVAE"}
WORK = "roofline:warm_block_work"


def vae_name(cfg: dict) -> str:
    return cfg["port"].get("vae_name", VAE_NAME)


def vae_stride(cfg: dict) -> Tuple[int, int, int]:
    return tuple(cfg["vae"].get("stride", VAE_STRIDE))


def vae_sizes(cfg: dict) -> dict:
    """The `vae` section's keys that size the port's VAE config."""
    return {k: v for k, v in cfg["vae"].items() if k != "stride"}


def latent_hw(cfg: dict) -> Tuple[int, int]:
    s, (_, sh, sw) = cfg["session"], vae_stride(cfg)
    return s["height"] // sh, s["width"] // sw


def latent_shape(cfg: dict, frames: int) -> tuple:
    """[1, frames, channels, h, w] of the session's noise."""
    return (1, frames, cfg["vae"]["z_dim"]) + latent_hw(cfg)


def _named(spec: str, package: str):
    module, name = spec.split(":")
    return getattr(importlib.import_module(f"{package}.{module}"), name)


def reference(cfg: dict, part: str):
    """The reference class of `part` ("dit" or "vae")."""
    return _named(cfg.get("reference_modules", {}).get(part, REFERENCE[part]),
                  "gpubench.reference")


def work(cfg: dict) -> dict:
    """A warm block's work by family, as the configuration counts it."""
    return _named(cfg.get("work", WORK), "gpubench")(cfg)
