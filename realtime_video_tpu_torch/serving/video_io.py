"""Video ingest / export utilities (reference: v2v.py, sample.py,
release_server.py:867-916); a copy of realtime_video_tpu/serving/video_io.py,
whose package cannot be imported without JAX. `cv2` and `ffmpeg` are used
only inside the calls that need them.

ffmpeg is used via subprocess exactly like the reference when present; when
absent (dev images), OpenCV's VideoWriter/VideoCapture covers mp4 IO.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

HAS_FFMPEG = shutil.which("ffmpeg") is not None
HAS_FFPROBE = shutil.which("ffprobe") is not None


def get_rotation_metadata(video_path: str) -> int:
    """Rotation tag via ffprobe (v2v.py:14-34); 0 when unavailable."""
    if not HAS_FFPROBE:
        return 0
    try:
        result = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream_tags=rotate", "-of", "json", video_path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=True, text=True,
        )
        tags = json.loads(result.stdout).get("streams", [{}])[0].get("tags", {})
        return int(tags.get("rotate", 0))
    except Exception:  # noqa: BLE001 — no rotation tag, or ffprobe failed
        return 0


def load_video_as_rgb(
    video_path: str,
    resample_to: Optional[int] = None,
    resample_frame_count_threshold: int = 81,
) -> np.ndarray:
    """Video file/URL -> [T, 3, H, W] float32 in [-1, 1] (v2v.py:36-131).

    Long clips are fps-resampled to 16 via ffmpeg when available.
    """
    import cv2

    temp_path = None
    if video_path.startswith(("http://", "https://")):
        import urllib.request

        with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
            temp_path = f.name
        urllib.request.urlretrieve(video_path, temp_path)
        video_path = temp_path

    rotation = get_rotation_metadata(video_path)
    resampled_path = video_path
    try:
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise IOError("Cannot open video file")
        frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()

        if (
            resample_to is not None
            and frame_count > resample_frame_count_threshold
            and HAS_FFMPEG
        ):
            with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
                resampled_path = f.name
            subprocess.run(
                ["ffmpeg", "-y", "-i", video_path, "-filter:v", f"fps={resample_to}",
                 "-c:v", "libx264", "-preset", "ultrafast", "-crf", "22", resampled_path],
                check=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )

        cap = cv2.VideoCapture(resampled_path)
        frames: List[np.ndarray] = []
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            if resampled_path == video_path:  # ffmpeg path already rotates
                if rotation == 90:
                    frame = cv2.rotate(frame, cv2.ROTATE_90_CLOCKWISE)
                elif rotation == 180:
                    frame = cv2.rotate(frame, cv2.ROTATE_180)
                elif rotation == 270:
                    frame = cv2.rotate(frame, cv2.ROTATE_90_COUNTERCLOCKWISE)
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
    finally:
        if resampled_path != video_path and os.path.exists(resampled_path):
            os.remove(resampled_path)
        if temp_path and os.path.exists(temp_path):
            os.remove(temp_path)

    arr = np.stack(frames).astype(np.float32) / 255.0  # [T, H, W, 3]
    arr = (arr - 0.5) / 0.5
    return arr.transpose(0, 3, 1, 2)


def resample_array(array, target_length: int):
    """Linear index resampling (release_server.py:59-64)."""
    if len(array) == target_length:
        return array
    idx = np.round(np.linspace(0, len(array) - 1, target_length)).astype(int)
    return [array[i] for i in idx]


def save_video_to_bytes(pixels: np.ndarray, fps: int = 24) -> Optional[bytes]:
    """[1, T, 3, H, W] in [0,1] -> mp4 bytes (release_server.py:867-916)."""
    video = np.clip(pixels[0], 0, 1)
    t, _, h, w = video.shape
    video_np = (video.transpose(0, 2, 3, 1) * 255).astype(np.uint8)
    with tempfile.NamedTemporaryFile(delete=False, suffix=".mp4") as f:
        tmp_path = f.name
    try:
        if HAS_FFMPEG:
            cmd = [
                "ffmpeg", "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
                "-s", f"{w}x{h}", "-pix_fmt", "rgb24", "-r", str(fps), "-i", "-",
                "-c:v", "libx264", "-pix_fmt", "yuv420p", "-crf", "18",
                "-preset", "fast", tmp_path,
            ]
            proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stderr=subprocess.PIPE)
            proc.stdin.write(video_np.tobytes())
            proc.stdin.close()
            proc.wait()
            if proc.returncode != 0:
                return None
        else:
            import cv2

            writer = cv2.VideoWriter(
                tmp_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
            )
            for fr in video_np:
                writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            writer.release()
        with open(tmp_path, "rb") as f:
            return f.read()
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def save_video_file(pixels: np.ndarray, path: str, fps: int = 16) -> None:
    data = save_video_to_bytes(pixels, fps)
    if data is None:
        raise RuntimeError("video mux failed")
    with open(path, "wb") as f:
        f.write(data)
