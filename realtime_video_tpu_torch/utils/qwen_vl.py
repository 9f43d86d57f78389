"""Qwen-VL vision preprocessing for the prompt expanders (a copy of
realtime_video_tpu/utils/qwen_vl.py, which is free of JAX).

Reference: wan/utils/qwen_vl_utils.py (vendored qwen-vl-utils) — image/video
preprocessing used by the local Qwen prompt expander
(wan/utils/prompt_extend.py:337-339 `process_vision_info`). Behavior carried:

  * smart_resize: keep aspect ratio, round H/W to a multiple of `factor`
    (28 = Qwen-VL patch*merge), clamp total pixels into [min_pixels,
    max_pixels], reject aspect ratios beyond 200:1 (qwen_vl_utils.py:54-82);
  * fetch_image: accept PIL image / local path / file:// / data:;base64 and
    apply smart_resize (or explicit resized_{height,width}) (:85-130);
  * smart_nframes: pick a frame count — explicit `nframes` rounded to
    FRAME_FACTOR, else fps-derived and clamped to [min_frames, max_frames],
    always a multiple of FRAME_FACTOR within [FRAME_FACTOR, total] (:133-176);
  * process_vision_info: walk chat messages and return (images, videos).

Heavy IO deps (PIL, cv2) are imported lazily so the module stays importable
in minimal environments; video decoding uses cv2 (the torchvision/decord
backends of the reference are CUDA-ecosystem choices, not behavior).
"""
from __future__ import annotations

import base64
import io
import math
from typing import Any, Optional

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> tuple[int, int]:
    """Target (h, w): factor-aligned, aspect-preserving, pixel-budgeted."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"aspect ratio must be < {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def _open_image(image: Any):
    from PIL import Image

    if isinstance(image, Image.Image):
        return image
    if isinstance(image, np.ndarray):
        return Image.fromarray(image)
    if isinstance(image, str):
        if image.startswith("data:image"):
            _, b64 = image.split("base64,", 1)
            return Image.open(io.BytesIO(base64.b64decode(b64)))
        if image.startswith("file://"):
            return Image.open(image[7:])
        if image.startswith(("http://", "https://")):
            raise ValueError(
                "remote image URLs need network access; download first"
            )
        return Image.open(image)
    raise ValueError(f"unsupported image spec: {type(image)}")


def fetch_image(ele: dict, size_factor: int = IMAGE_FACTOR):
    """Resolve one image element {'image'|'image_url': ..., size hints}."""
    img = _open_image(ele.get("image", ele.get("image_url"))).convert("RGB")
    if "resized_height" in ele and "resized_width" in ele:
        h, w = smart_resize(
            ele["resized_height"], ele["resized_width"], factor=size_factor
        )
    else:
        h, w = smart_resize(
            img.height,
            img.width,
            factor=size_factor,
            min_pixels=ele.get("min_pixels", MIN_PIXELS),
            max_pixels=ele.get("max_pixels", MAX_PIXELS),
        )
    return img.resize((w, h))


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Frame count for a video element — multiple of FRAME_FACTOR."""
    if "nframes" in ele and "fps" in ele:
        raise ValueError("give only one of `fps` or `nframes`")
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(
            ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR
        )
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR,
        )
        nframes = total_frames / video_fps * fps
        nframes = min(max(nframes, min_frames), max_frames)
        nframes = round_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes must be in [{FRAME_FACTOR}, {total_frames}], "
            f"got {nframes}"
        )
    return int(nframes)


def fetch_video(ele: dict) -> np.ndarray:
    """Decode + sample a video element to [T, H, W, 3] uint8 (cv2 backend)."""
    import cv2

    path = ele["video"]
    if isinstance(path, str) and path.startswith("file://"):
        path = path[7:]
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video: {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    video_fps = cap.get(cv2.CAP_PROP_FPS) or FPS
    nframes = smart_nframes(ele, total_frames=total, video_fps=video_fps)
    idx = np.round(np.linspace(0, total - 1, nframes)).astype(int)
    frames, want, j = [], set(idx.tolist()), 0
    for i in range(total):
        ok, frame = cap.read()
        if not ok:
            break
        if i in want:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        j += 1
    cap.release()
    video = np.stack(frames)
    t, h, w, _ = video.shape
    max_pixels = max(
        min(VIDEO_MAX_PIXELS, VIDEO_TOTAL_PIXELS / t * FRAME_FACTOR),
        int(VIDEO_MIN_PIXELS * 1.05),
    )
    nh, nw = smart_resize(
        h, w,
        factor=IMAGE_FACTOR,
        min_pixels=ele.get("min_pixels", VIDEO_MIN_PIXELS),
        max_pixels=ele.get("max_pixels", max_pixels),
    )
    return np.stack([
        cv2.resize(f, (nw, nh), interpolation=cv2.INTER_CUBIC) for f in video
    ])


def extract_vision_info(conversations) -> list[dict]:
    """Flatten chat-message content lists to vision elements."""
    if isinstance(conversations, dict):
        conversations = [conversations]
    if conversations and isinstance(conversations[0], dict):
        conversations = [conversations]
    infos = []
    for conv in conversations:
        for msg in conv:
            content = msg.get("content")
            if not isinstance(content, list):
                continue
            for ele in content:
                if isinstance(ele, dict) and (
                    "image" in ele or "image_url" in ele or "video" in ele
                    or ele.get("type") in ("image", "image_url", "video")
                ):
                    infos.append(ele)
    return infos


def process_vision_info(conversations):
    """(images, videos) lists for a chat, ready for the Qwen-VL processor."""
    images, videos = [], []
    for ele in extract_vision_info(conversations):
        if "image" in ele or "image_url" in ele:
            images.append(fetch_image(ele))
        elif "video" in ele:
            videos.append(fetch_video(ele))
        else:
            raise ValueError("vision element has no image/video key")
    return images or None, videos or None
