"""Offline batch sampling over the session (`sample.py`), a mirror of
tests/test_sample.py on the port: two prompts of 2 blocks each give 18
frames [3, 64, 64] in [0, 1] and one file each, mp4 when a writer is present
and the .npy fallback when none is.

Against the JAX package's sample_videos on the same tiny bf16 models (those
of tests/test_torch_session.py), each port session fed the JAX session's
noise: its initial latents and its per-step draws from the same `jax.random`
key. Both sessions run bf16, so the bar is the session tests' bf16 one:
frames in [0, 1] within mean abs 1.5e-2 (half of the [-1, 1] bar there), and
relative Frobenius 2e-2."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.sample import sample_videos as jsample_videos
from realtime_video_tpu.serving.params import GenerateParams as JParams
from realtime_video_tpu_torch import sample as tsample
from realtime_video_tpu_torch.serving import video_io
from realtime_video_tpu_torch.serving.params import GenerateParams as TParams
from realtime_video_tpu_torch.serving.session import GenerationSession
from test_torch_session import stacks  # noqa: F401  (the shared tiny models)

REQ = dict(prompt="", width=64, height=64, seed=0, num_blocks=2, num_denoising_steps=2)


class JaxNoiseSession(GenerationSession):
    """The port's session with the JAX session's draws (session.py of the JAX
    package: one key split for the initial noise, then one per step)."""

    def __init__(self, params, config, frame_callback=None, models=None):
        key, sub = jax.random.split(jax.random.PRNGKey(params.seed))
        shape = (1, params.num_blocks * 3, 16, params.height // 8, params.width // 8)
        noise = jax.random.normal(sub, shape, jnp.float32).astype(jnp.bfloat16)
        state = {"k": key}

        def draws(shape, dtype, device):
            state["k"], s = jax.random.split(state["k"])
            nz = jax.random.normal(s, shape, jnp.float32).astype(jnp.bfloat16)
            return torch.from_numpy(np.array(nz.astype(jnp.float32))).to(dtype)

        super().__init__(params, config, frame_callback=frame_callback, models=models,
                         noise=torch.from_numpy(np.array(noise.astype(jnp.float32))),
                         noise_fn=draws)


def _writer_available() -> bool:
    if video_io.HAS_FFMPEG:
        return True
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.parametrize("writer", ["mp4", "none"])
def test_sample_videos_matches_jax(stacks, tmp_path, monkeypatch, writer):  # noqa: F811
    _, jm, tm = stacks
    monkeypatch.setenv("RTV_SESSION_MEGAFUSE", "0")
    monkeypatch.setattr(tsample, "GenerationSession", JaxNoiseSession)
    if writer == "none":  # no ffmpeg and no cv2: the .npy fallback
        monkeypatch.setattr(video_io, "HAS_FFMPEG", False)
        monkeypatch.setitem(sys.modules, "cv2", None)
    prompts = ["a cat", "a dog"]
    got = tsample.sample_videos(prompts, None, str(tmp_path / "port"), TParams(**REQ),
                                tm, save_videos=True)
    assert len(got) == 2 and all(v.shape == (18, 3, 64, 64) for v in got)
    assert all(np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1 for v in got)
    ext = ".mp4" if writer == "mp4" and _writer_available() else ".npy"
    assert sorted(os.listdir(tmp_path / "port")) == [f"video_00{i}{ext}" for i in (0, 1)]
    if ext == ".npy":
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "video_001.npy"), got[1])
    want = jsample_videos(prompts, None, str(tmp_path / "jax"), JParams(**REQ), jm,
                          save_videos=False)
    for g, w in zip(got, want):
        assert float(np.abs(g - w).mean()) < 1.5e-2
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 2e-2
