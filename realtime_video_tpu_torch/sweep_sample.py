"""Checkpoint-sweep quality harness (port of the repo's sweep_sample.py;
reference: sweep_sample.py).

For each checkpoint: load its weights into the transformer, sample a fixed
prompt battery at a fixed seed into a per-checkpoint directory, and
optionally composite a side-by-side grid for human A/B review.

    python -m realtime_video_tpu_torch.sweep_sample ckpt_a.safetensors ckpt_b.pt \\
        [--config server.yaml] [--out sweep_outputs] [--first-n 15] [--grid] \\
        [--device cuda]

The models load on the CUDA card unless `--device` names another. A
checkpoint path that does not exist samples the weights already loaded.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

SWEEP_PROMPTS = [
    "a cat surfing a wave at sunset, cinematic lighting",
    "a timelapse of a city skyline at night",
    "a golden retriever running through a field of flowers",
    "macro shot of a butterfly landing on a flower",
    "a steaming cup of coffee on a rainy window sill",
    "fireworks exploding over a mountain lake",
    "a robot walking through a neon-lit alley",
    "waves crashing on a rocky coastline, aerial view",
    "a chef flipping a pancake in a rustic kitchen",
    "snow falling on a quiet forest trail",
    "a hot air balloon drifting over desert dunes",
    "a street musician playing violin in the rain",
    "northern lights dancing over a frozen lake",
    "a skateboarder doing tricks in an empty pool",
    "a painter's brush adding color to a canvas",
]


def load_ckpt(models, ckpt_path: str) -> None:
    """Load new transformer weights into the live Models (reference
    sweep_sample.py:7-21 strips the 'model.' prefix before loading, as
    `load_wan_dit` does), in the transformer's dtype and on its device; a
    checkpoint of another width is refused."""
    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.utils.checkpoint import load_wan_dit

    tr = models.transformer
    cfg, params = load_wan_dit(ckpt_path, dtype=tr.dtype, device=tr.device)
    if cfg.dim != tr.cfg.dim:
        raise ValueError(f"checkpoint/model dim mismatch: {ckpt_path} is {cfg.dim} wide, "
                         f"the model {tr.cfg.dim}")
    tr.params = params
    tr.layers = wan_dit.layer_params(params, cfg.num_layers)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoints", nargs="+", help="checkpoint files to sweep")
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default="sweep_outputs")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--num-blocks", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--first-n", type=int, default=len(SWEEP_PROMPTS))
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[np.ndarray]]:
    """Sample every checkpoint; returns {checkpoint name: its videos}."""
    args = parse_args(argv)

    from realtime_video_tpu_torch.config import load_server_config
    from realtime_video_tpu_torch.sample import create_grid, sample_videos
    from realtime_video_tpu_torch.serving.models import load_all
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.utils.device import resolve_device

    config = load_server_config(args.config)
    models = load_all(config, resolve_device(args.device), seed=config.get("seed", 0))
    prompts = SWEEP_PROMPTS[: args.first_n]

    results = {}
    for ckpt in args.checkpoints:
        name = os.path.splitext(os.path.basename(ckpt))[0]
        out_dir = os.path.join(args.out, name)
        if os.path.exists(ckpt):
            load_ckpt(models, ckpt)
        params = GenerateParams(prompt="", seed=args.seed, num_blocks=args.num_blocks,
                                num_denoising_steps=args.steps)
        results[name] = sample_videos(prompts, args.config, out_dir, params, models)
        if args.grid:
            vids = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                          if f.endswith(".mp4"))
            if vids:
                create_grid(vids, os.path.join(out_dir, "grid.mp4"))
    return results


if __name__ == "__main__":
    main()
