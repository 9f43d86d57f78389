"""Example: video-to-video restyling (port of the repo's
examples/sample_example.py; reference: sample_example.ipynb).

Encodes an input clip, mixes noise at `strength`, and regenerates it with a
new prompt through the causal pipeline. The models load on the CUDA card
unless `--device` names another.

    python -m realtime_video_tpu_torch.examples.sample_example --video in.mp4 \\
        --prompt "anime style" --strength 0.7 --out restyled.mp4 [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--video", required=True)
    ap.add_argument("--prompt", default="cinematic, high quality")
    ap.add_argument("--strength", type=float, default=0.7)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--out", default="restyled.mp4")
    ap.add_argument("--config", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Restyle one clip; returns its frames [T, 3, H, W] in [0, 1]."""
    args = parse_args(argv)

    from realtime_video_tpu_torch.config import load_server_config
    from realtime_video_tpu_torch.sample import save_video_direct
    from realtime_video_tpu_torch.serving.models import load_all
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession
    from realtime_video_tpu_torch.utils.device import resolve_device

    config = load_server_config(args.config)
    models = load_all(config, resolve_device(args.device), seed=config.get("seed", 0))
    params = GenerateParams(prompt=args.prompt, seed=args.seed, strength=args.strength,
                            num_blocks=args.blocks, num_denoising_steps=args.steps,
                            input_video=args.video)
    collected = []
    session = GenerationSession(
        params, config,
        frame_callback=lambda p, i, e: collected.append(
            np.clip((p.float().cpu().numpy() + 1) * 0.5, 0, 1)),
        models=models)
    for _ in range(session.num_blocks):
        session.generate_block(models)
    frames = np.concatenate(collected, axis=1)[0]
    save_video_direct(frames, args.out)
    print(f"wrote {args.out}: {frames.shape[0]} frames")
    return frames


if __name__ == "__main__":
    main()
