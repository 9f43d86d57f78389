"""Example: offline text-to-video generation (port of the repo's
examples/generate.py; reference: generate.ipynb).

Runs the causal few-step pipeline end to end through the serving session.
Without checkpoints under MODEL_FOLDER this uses random weights (a structure
and speed demo only). The models load on the CUDA card unless `--device`
names another.

    python -m realtime_video_tpu_torch.examples.generate --prompt "a cat surfing" \\
        --blocks 3 --steps 4 [--config server.yaml] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt", default="a cat surfing a wave at sunset")
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default="generated.mp4")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=832)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--input-video", default=None, help="v2v source")
    ap.add_argument("--strength", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Generate one clip; returns its frames [T, 3, H, W] in [0, 1]."""
    args = parse_args(argv)

    from realtime_video_tpu_torch.sample import sample_videos, save_video_direct
    from realtime_video_tpu_torch.serving.params import GenerateParams

    params = GenerateParams(prompt=args.prompt, width=args.width, height=args.height,
                            seed=args.seed, num_blocks=args.blocks,
                            num_denoising_steps=args.steps, input_video=args.input_video,
                            strength=args.strength)
    out_dir = os.path.dirname(args.out) or "."
    videos = sample_videos([args.prompt], args.config, out_dir, params, save_videos=False,
                           device=args.device)
    save_video_direct(videos[0], args.out)
    print(f"wrote {args.out}: {videos[0].shape[0]} frames")
    return videos[0]


if __name__ == "__main__":
    main()
