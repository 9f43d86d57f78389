"""One-shot real-weight integration run (port of the repo's
scripts/run_real_checkpoint.py; reference: release_server.py:150-188).

Loads the Wan checkpoints (DiT safetensors, VAE .pth, umT5 encoder) from
MODEL_FOLDER through utils/checkpoint.py, generates a short fixed-seed clip
through the serving session, and prints a frame checksum so that runs are
comparable across machines. Exits 0, naming what is missing, when the
weight set is absent.

    MODEL_FOLDER=~/models python -m realtime_video_tpu_torch.scripts.run_real_checkpoint \\
        [--prompt "..."] [--blocks 3] [--steps 4] [--out outputs/real.mp4] [--device cuda]

The models load on the CUDA card unless `--device` names another. The last
line of the output is one JSON object: the frames' shape, whether all are
finite, the checksum, each file's load-and-convert seconds, the load's peak
device memory and the sampling seconds.

Checkpoint layout expected under MODEL_FOLDER (the reference's, README.md:53):
    Wan2.1-T2V-1.3B/Wan2.1_VAE.pth
    Wan2.1-T2V-1.3B/models_t5_umt5-xxl-enc-bf16.safetensors
    Wan2.1-T2V-1.3B/google/umt5-xxl/  (tokenizer files; else the fallback tokenizer)
    <the DiT: --checkpoint, else the first DiT safetensors under MODEL_FOLDER;
     1.3B vs 14B autodetected>
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys
import time
from typing import Optional, Sequence


def find_dit_checkpoint(model_folder: str) -> Optional[str]:
    """The first top-level (then one level down) safetensors that looks like a
    DiT: the umT5 and CLIP files are skipped (release_server.py:162-165
    autodetects the size from the weights, as load_wan_dit does)."""
    for pattern in ("*.safetensors", "*/*.safetensors"):
        for p in sorted(glob.glob(os.path.join(model_folder, pattern))):
            base = os.path.basename(p)
            if "t5" in base or "umt5" in base or "clip" in base.lower():
                continue
            return p
    return None


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt", default="a corgi running on a beach at sunset")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=832)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--out", default="outputs/real_checkpoint.mp4")
    ap.add_argument("--checkpoint", default=None, help="DiT safetensors path")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)

    from realtime_video_tpu_torch.config import MODEL_FOLDER

    dit_ckpt = args.checkpoint or find_dit_checkpoint(MODEL_FOLDER)
    vae_ckpt = os.path.join(MODEL_FOLDER, "Wan2.1-T2V-1.3B", "Wan2.1_VAE.pth")
    t5_ckpt = os.path.join(MODEL_FOLDER, "Wan2.1-T2V-1.3B",
                           "models_t5_umt5-xxl-enc-bf16.safetensors")
    missing = [p for p in (dit_ckpt, vae_ckpt, t5_ckpt) if not (p and os.path.exists(p))]
    if missing:
        print("real-checkpoint run SKIPPED: weights not present:")
        for p in missing:
            print(f"  missing: {p or '<no DiT safetensors under MODEL_FOLDER>'}")
        print(f"(MODEL_FOLDER={MODEL_FOLDER}; see the module docstring for the layout)")
        return 0

    import numpy as np
    import torch

    from realtime_video_tpu_torch.config import load_server_config
    from realtime_video_tpu_torch.sample import sample_videos, save_video_direct
    from realtime_video_tpu_torch.serving.models import load_all
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_server_config(checkpoint_path=dit_ckpt, num_denoising_steps=args.steps)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    models = load_all(config, device)
    load_peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                 if device.type == "cuda" else None)
    files = {"transformer": dit_ckpt, "text_encoder": t5_ckpt, "vae": vae_ckpt}
    load_s = {os.path.basename(files[k]): v for k, v in models.load_seconds.items()}
    params = GenerateParams(prompt=args.prompt, width=args.width, height=args.height,
                            seed=args.seed, num_blocks=args.blocks,
                            num_denoising_steps=args.steps)
    t0 = time.perf_counter()
    vids = sample_videos([args.prompt], params=params, models=models, save_videos=False,
                         output_dir=os.path.dirname(args.out) or ".")
    sample_s = time.perf_counter() - t0
    frames = vids[0]  # [T, 3, H, W] float [0, 1]
    u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    digest = hashlib.sha256(u8.tobytes()).hexdigest()[:16]
    print(f"frames: {frames.shape}  checksum(sha256/16): {digest}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    try:
        save_video_direct(frames, args.out)
        saved = args.out
    except (ImportError, OSError, RuntimeError) as e:  # no mp4 writer: keep the frames
        saved = args.out.replace(".mp4", ".npy")
        np.save(saved, frames)
        print(f"mp4 save failed ({e}); saved .npy instead")
    print(f"saved: {saved}")
    print(json.dumps({"real_checkpoint": {
        "frames": list(frames.shape), "finite": bool(np.isfinite(frames).all()),
        "checksum": digest, "load_convert_s": load_s, "load_peak_gib": load_peak,
        "sample_s": sample_s, "saved": saved, "device": str(device),
        "dit_checkpoint": os.path.basename(dit_ckpt)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
