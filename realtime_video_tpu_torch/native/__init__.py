"""The server's native JPEG frame codec, loaded with ctypes (port of
realtime_video_tpu/native/__init__.py, whose package cannot be imported
without JAX).

The repo's `native/frame_codec.cpp` (float -> uint8 conversion and a
libjpeg(-turbo) encode in one C call that releases the GIL, so the server's
encode pool runs in parallel) is built with g++ at its first use into
`_build/` next to the package, which git ignores; the library's name carries
a hash of the source, so a stale build is never loaded. Without g++ or
libjpeg the build fails once, `encode_jpeg_planar` returns None from then
on, and the server encodes with PIL. This is a host codec, not a device
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "frame_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libframecodec-{h}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        lib_path = library_path()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-ljpeg"],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, lib_path)  # atomic: a concurrent build never loads a partial file
        lib = ctypes.CDLL(str(lib_path))
        lib.jpeg_encode_rgb.restype = ctypes.c_long
        lib.jpeg_encode_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long,
        ]
        lib.jpeg_encode_planar_float.restype = ctypes.c_long
        lib.jpeg_encode_planar_float.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_long,
        ]
        return lib
    except Exception as e:  # noqa: BLE001 — no g++, no libjpeg: the server uses PIL
        log.warning("native frame codec unavailable (%s); using PIL", e)
        _build_failed = True
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lib_lock:
            if _lib is None and not _build_failed:
                _lib = _build()
    return _lib


def available() -> bool:
    """Whether the native codec is built and loaded (building it if need be)."""
    return _get_lib() is not None


def encode_jpeg_planar(frame: np.ndarray, quality: int = 90, scale: float = 1.0,
                       offset: float = 0.0) -> Optional[bytes]:
    """[3, H, W] float32 -> JPEG bytes via the native codec (pixel value =
    v * scale + offset, clipped to [0, 1]); None if it is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    frame = np.ascontiguousarray(frame, np.float32)
    _, h, w = frame.shape
    cap = h * w * 3 + 65536
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode_planar_float(
        frame.ctypes.data_as(ctypes.c_void_p), h, w, quality,
        ctypes.c_float(scale), ctypes.c_float(offset),
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if n <= 0:
        return None
    return out[:n].tobytes()
