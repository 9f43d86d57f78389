"""The port's loader of the native JPEG frame codec: it builds the repo's
native/frame_codec.cpp with g++ into the package's git-ignored `_build/`
(skips without g++), and a [3, H, W] float frame round-trips through it and
PIL's decoder within JPEG's loss; the server's `_jpeg_bytes` serves through
it, and falls back to PIL when it is unavailable."""
import shutil
from io import BytesIO

import numpy as np
import pytest
from PIL import Image

from realtime_video_tpu_torch import native
from realtime_video_tpu_torch.serving import server


def _frame(h=48, w=80) -> np.ndarray:
    """A smooth [3, H, W] frame in [0, 1] (JPEG keeps smooth content close)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([xx / w, yy / h, 0.5 + 0.25 * np.sin(xx / 7.0)]).astype(np.float32)


def test_native_codec_builds_and_round_trips():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the server encodes with PIL")
    frame = _frame()
    data = native.encode_jpeg_planar(frame, quality=95)
    assert native.available() and native.library_path().exists()
    assert native.library_path().parent.name == "_build"
    assert data is not None and data[:2] == b"\xff\xd8"  # a JPEG stream
    back = np.asarray(Image.open(BytesIO(data)).convert("RGB"), np.float32) / 255.0
    assert back.shape == (48, 80, 3)
    assert float(np.abs(back.transpose(2, 0, 1) - frame).mean()) < 0.01
    # scale and offset map [-1, 1] pixels as the codec's caller may ask
    data2 = native.encode_jpeg_planar(frame * 2.0 - 1.0, quality=95, scale=0.5, offset=0.5)
    back2 = np.asarray(Image.open(BytesIO(data2)).convert("RGB"), np.float32) / 255.0
    assert float(np.abs(back2 - back).mean()) < 0.01
    assert server._jpeg_bytes(frame, 95) == data


def test_server_falls_back_to_pil(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    assert native.encode_jpeg_planar(_frame()) is None and not native.available()
    data = server._jpeg_bytes(_frame(), 90)
    assert Image.open(BytesIO(data)).size == (80, 48)
