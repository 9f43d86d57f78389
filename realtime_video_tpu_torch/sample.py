"""Offline batch sampling over the serving session (port of
realtime_video_tpu/sample.py, after the reference's sample.py, which drives
the server's GenerationSession block by block and collects its frames).

    from realtime_video_tpu_torch.sample import sample_videos
    sample_videos(["a red fox running through snow"], "config.yaml", "outputs")

Without `models` it builds them with `load_all` on the card. Videos are
written as mp4 (the ffmpeg mux of `serving/video_io.py`), or as .npy arrays
[T, 3, H, W] in [0, 1] when no mp4 can be written.
"""
from __future__ import annotations

import logging
import os
import subprocess
import time
from typing import List, Optional

import numpy as np

from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.serving.models import Models, load_all
from realtime_video_tpu_torch.serving.params import GenerateParams
from realtime_video_tpu_torch.serving.session import GenerationSession
from realtime_video_tpu_torch.serving.video_io import HAS_FFMPEG, save_video_file
from realtime_video_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def save_video_direct(frames: np.ndarray, path: str, fps: int = 16) -> None:
    """[T, 3, H, W] float in [0, 1] -> mp4 (sample.py:28-54)."""
    save_video_file(frames[None], path, fps=fps)


def save_video_frames(frames: np.ndarray, out_dir: str) -> None:
    """Dump frames as PNGs (sample.py:101-147)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, fr in enumerate(frames):
        arr = (np.clip(fr, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(arr).save(os.path.join(out_dir, f"frame_{i:05d}.png"))


def sample_videos(prompts_list: List[str], config_path: Optional[str] = None,
                  output_dir: str = "outputs", params: Optional[GenerateParams] = None,
                  models: Optional[Models] = None, save_videos: bool = True, fps: int = 16,
                  device=None) -> List[np.ndarray]:
    """One video per prompt (sample.py:149-251): [T, 3, H, W] float arrays in
    [0, 1]. Without `models`, load_all builds them on `device` (default: the
    CUDA card)."""
    config = load_server_config(config_path)
    if models is None:
        models = load_all(config, resolve_device(device), seed=config.get("seed", 0))
    os.makedirs(output_dir, exist_ok=True)

    results = []
    for pi, prompt in enumerate(prompts_list):
        p = (params or GenerateParams(prompt=prompt)).model_copy()
        p.prompt = prompt
        if p.seed is None:
            p.seed = config.get("seed", 0)
        collected: List[np.ndarray] = []

        def frame_callback(pixels, frame_ids, event, collected=collected):
            arr = pixels.float().cpu().numpy()
            collected.append(np.clip((arr + 1.0) * 0.5, 0.0, 1.0))

        session = GenerationSession(p, config, frame_callback=frame_callback, models=models)
        t0 = time.time()
        for _ in range(session.num_blocks):
            session.generate_block(models)
        frames = np.concatenate(collected, axis=1)[0]  # [T, 3, H, W]
        dt = time.time() - t0
        log.info("prompt %d: %d frames in %.2fs (%.2f fps)", pi, frames.shape[0], dt,
                 frames.shape[0] / dt)
        results.append(frames)
        if save_videos:
            out_path = os.path.join(output_dir, f"video_{pi:03d}.mp4")
            try:
                save_video_direct(frames, out_path, fps=fps)
            except (ImportError, OSError, RuntimeError) as e:  # no mp4 writer
                log.warning("mp4 save failed (%s); dumping .npy", e)
                np.save(out_path.replace(".mp4", ".npy"), frames)
    return results


def sample_single_video(prompt: str, config_path: Optional[str] = None,
                        output_path: str = "output.mp4",
                        params: Optional[GenerateParams] = None,
                        models: Optional[Models] = None, fps: int = 16,
                        device=None) -> np.ndarray:
    """Single-prompt convenience (sample.py:403-450)."""
    out_dir = os.path.dirname(output_path) or "."
    vids = sample_videos([prompt], config_path, out_dir, params, models, save_videos=False,
                         fps=fps, device=device)
    save_video_direct(vids[0], output_path, fps=fps)
    return vids[0]


def create_grid(video_paths: List[str], output_path: str, cols: int = 4,
                fps: int = 16) -> None:
    """ffmpeg xstack side-by-side compositing (sample.py:254-400)."""
    if not HAS_FFMPEG:
        raise RuntimeError("create_grid requires ffmpeg")
    n = len(video_paths)
    inputs = []
    for p in video_paths:
        inputs += ["-i", p]

    def pos(i: int) -> str:
        col, row = i % cols, i // cols
        x = "+".join(["w0"] * col) if col else "0"
        y = "+".join(["h0"] * row) if row else "0"
        return f"{x}_{y}"

    layout = "|".join(pos(i) for i in range(n))
    filt = "".join(f"[{i}:v]" for i in range(n)) + f"xstack=inputs={n}:layout={layout}[v]"
    subprocess.run(["ffmpeg", "-y", *inputs, "-filter_complex", filt, "-map", "[v]",
                    "-c:v", "libx264", "-r", str(fps), output_path],
                   check=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
