"""Image helpers (port of realtime_video_tpu/utils/image.py; reference
demo_utils/utils.py): resize and crop, JSON I/O, LoRA parameter utilities,
and the bicubic resize shared by the CLIP tower and the serving session.
PIL is imported where it is used."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bicubic(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """frames [T, C, H, W] f32 -> [T, C, height, width], as
    `jax.image.resize(..., "bicubic")`: Keys' cubic with a = -0.5, widened by
    the scale when it shrinks (antialiasing). PyTorch's antialiased bicubic is
    that filter; its plain bicubic (a = -0.75, never widened) is not."""
    return F.interpolate(frames, size=(height, width), mode="bicubic", align_corners=False,
                         antialias=True)


def _to_uint8(image: np.ndarray) -> np.ndarray:
    if image.dtype == np.uint8:
        return image
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def _like(out: np.ndarray, image: np.ndarray) -> np.ndarray:
    """Back to [0, 1] floats when the input was not uint8."""
    return out if image.dtype == np.uint8 else out.astype(np.float32) / 255.0


def resize_and_center_crop(image: np.ndarray, target_width: int,
                           target_height: int) -> np.ndarray:
    """[H, W, C] uint8 or [0, 1] float -> resized (Lanczos) to cover the
    target, then center-cropped to (target_height, target_width)
    (demo_utils/utils.py resize_and_center_crop)."""
    from PIL import Image

    h, w = image.shape[:2]
    scale = max(target_width / w, target_height / h)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    im = Image.fromarray(_to_uint8(image)).resize((new_w, new_h), Image.LANCZOS)
    left = (new_w - target_width) // 2
    top = (new_h - target_height) // 2
    im = im.crop((left, top, left + target_width, top + target_height))
    return _like(np.asarray(im), image)


def resize_without_crop(image: np.ndarray, target_width: int, target_height: int) -> np.ndarray:
    """[H, W, C] -> (target_height, target_width) by Lanczos, aspect not kept."""
    from PIL import Image

    im = Image.fromarray(_to_uint8(image)).resize((target_width, target_height), Image.LANCZOS)
    return _like(np.asarray(im), image)


def generate_timestamp() -> str:
    import random
    import time

    return time.strftime("%y%m%d_%H%M%S") + f"_{random.randint(0, 9999):04d}"


def read_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_json(path: str, data: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)


# -- LoRA parameter utilities (demo_utils/utils.py LoRA helpers) -------------


def merge_lora_delta(w: torch.Tensor, lora_down, lora_up, alpha: float = 1.0) -> torch.Tensor:
    """w [in, out] + alpha * (down [in, r] @ up [r, out]): a LoRA pair folded
    into a base weight (weights here are [in, out]; torch checkpoints come as
    [out, in] and the checkpoint converters transpose them). The pair may be
    numpy or tensors; the product is taken in w's dtype on w's device."""
    w = torch.as_tensor(w)
    down = torch.as_tensor(lora_down, dtype=w.dtype, device=w.device)
    up = torch.as_tensor(lora_up, dtype=w.dtype, device=w.device)
    return w + alpha * (down @ up)


def apply_lora_to_params(params: Dict[str, Any], lora: Dict[str, Tuple[Any, Any]],
                         alpha: float = 1.0) -> Dict[str, Any]:
    """A copy of the dict-of-tensor tree `params` with {path: (down, up)}
    LoRA pairs folded in; paths join keys with '/', e.g.
    'blocks/self_attn/q/w'. The input tree is left as it was."""

    def copy(node):
        return {k: copy(v) for k, v in node.items()} if isinstance(node, dict) else node

    out = copy(params)
    for path, (down, up) in lora.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = merge_lora_delta(node[keys[-1]], down, up, alpha)
    return out
