"""Dump teacher ODE trajectories for ODE-regression distillation (port of the
repo's scripts/generate_ode_pairs.py; reference scripts/generate_ode_pairs.py).

For each prompt of this shard, the bidirectional teacher (the config's
`model_name`, its `teacher_checkpoint_path` when that file exists, else
random weights) runs `--steps` UniPC steps of its conditional train-mode
forward alone (no CFG, no mask: every token attends to all of them, the
attention kernel's unmasked window on a card) from seeded noise, and the
latents before the first step and after each one are kept as a float16
trajectory [steps + 1, 1, F, 16, h, w] beside the prompt; `--shard-size`
trajectories make one npz shard (`utils/dataset.save_ode_shard`).

    python -m realtime_video_tpu_torch.scripts.generate_ode_pairs \\
        --prompts prompts.txt --out ode_shards/ --steps 48 --num-frames 21 \\
        [--tiny] [--config server.yaml] [--device cuda|cpu]

`--tiny` is a 2-layer, 64-wide f32 teacher on 4x4 latents. The teacher
runs on the CUDA card unless `--device` names another. `--config` is a
server YAML over the built-in defaults (`random_heads: true` swaps the
zero-initialised output head of random weights for N(0, 0.05) draws, as
train.py does). Prompt i's noise comes from `torch.Generator().manual_seed(i)`
(the JAX script draws from `jax.random.PRNGKey(i)`: other numbers).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from realtime_video_tpu_torch.config import WanModelConfig, load_server_config
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.pipelines import BidirectionalDiffusionInferencePipeline
from realtime_video_tpu_torch.serving.models import load_text_encoder
from realtime_video_tpu_torch.solvers import FlowUniPCMultistep
from realtime_video_tpu_torch.train import random_head
from realtime_video_tpu_torch.utils.dataset import TextDataset, save_ode_shard
from realtime_video_tpu_torch.utils.device import resolve_device

TINY = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompts", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--num-frames", type=int, default=21)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=832)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--shard-size", type=int, default=16)
    ap.add_argument("--tiny", action="store_true", help="tiny model smoke mode")
    ap.add_argument("--config", default=None, help="server YAML (default: built-in)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def ode_trajectory(gen: WanDiffusion, cross, noise: torch.Tensor,
                   solver) -> List[torch.Tensor]:
    """The teacher's ODE from `noise` [B, F, C, h, w]: the latents (in the
    generator's dtype) before the first of `solver`'s timesteps and after
    each step, each step one conditional train-mode forward on the text K/V
    `cross` and one `solver.step`."""
    b, f = noise.shape[:2]
    latent = noise.to(gen.device, gen.dtype)
    traj = [latent]
    with torch.no_grad():
        for t_val in solver.timesteps:
            t = torch.full((b, f), float(t_val), dtype=torch.float32, device=gen.device)
            flow, _, _ = gen.forward(latent, cross, t, mode="train")
            latent = solver.step(flow, float(t_val), latent)
            traj.append(latent)
    return traj


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Write this shard's npz files; returns their paths."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_server_config(args.config, sampling_steps=args.steps)
    if args.tiny:
        gen = WanDiffusion(cfg=TINY, dtype=torch.float32, device=device, fuse_qkv=False)
        lat_h, lat_w = 4, 4
    else:
        gen = WanDiffusion(checkpoint_path=config.get("teacher_checkpoint_path", ""),
                           model_name=config.get("model_name", "t2v-1.3B"), device=device,
                           timestep_shift=config.get("timestep_shift", 5.0), fuse_qkv=False)
        lat_h, lat_w = args.height // 8, args.width // 8
    if config.get("random_heads", False):
        random_head(gen, 20)
    text_encoder = load_text_encoder(config, device, text_len=gen.cfg.text_len,
                                     text_dim=gen.cfg.text_dim)
    pipe = BidirectionalDiffusionInferencePipeline(config, gen, text_encoder)

    prompts = TextDataset(args.prompts)
    os.makedirs(args.out, exist_ok=True)
    written, records, shard_idx = [], [], 0

    def flush():
        path = os.path.join(args.out, f"shard_{args.shard}_{shard_idx:04d}.npz")
        save_ode_shard(path, records)
        written.append(path)

    for i in range(args.shard, len(prompts), args.num_shards):
        prompt = prompts[i]["prompts"]
        noise = torch.randn((1, args.num_frames, 16, lat_h, lat_w),
                            generator=torch.Generator().manual_seed(i))
        # the JAX script rounds the embedding to bf16 before the text K/V
        embeds = text_encoder([prompt])["prompt_embeds"].to(torch.bfloat16)
        with torch.no_grad():
            cross = gen.compute_crossattn_cache(embeds.to(device, gen.dtype))
        solver = FlowUniPCMultistep(shift=pipe.shift)
        solver.set_timesteps(pipe.sampling_steps)
        traj = ode_trajectory(pipe.generator, cross, noise, solver)
        # [steps + 1, 1, F, 16, h, w], the JAX script's layout
        records.append({"ode_latent": np.stack([x.float().cpu().numpy().astype(np.float16)
                                                for x in traj]), "prompts": prompt})
        print(f"[{args.shard}] prompt {i}: trajectory {records[-1]['ode_latent'].shape}",
              flush=True)
        if len(records) >= args.shard_size:
            flush()
            records, shard_idx = [], shard_idx + 1
    if records:
        flush()
    return written


if __name__ == "__main__":
    main()
