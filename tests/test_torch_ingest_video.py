"""Video-in sessions of the port against the JAX session on the CPU at tiny
dims: webcam mode over 2 blocks with the frames pushed as JPEG bytes, and an
`input_video` clip written by cv2. Parameters come from one JAX tree, carried
across; every random draw of the port's session (the clip's noise at set-up,
each block's webcam noise, the denoise's renoise) is fed the JAX session's
own `jax.random` stream, whose key must end where the JAX session's does.
Bars as for the t2v session (tests/test_torch_session.py): latents atol 5e-2
+ rtol 2e-2, pixels mean abs difference < 3e-2."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ingest import as_np, assert_latents_match, assert_same_key, jax_noise_stream
from test_torch_session import REQ, stacks  # noqa: F401 (fixture)

from realtime_video_tpu.serving.params import GenerateParams as JParams
from realtime_video_tpu.serving.session import GenerationSession as JSession
from realtime_video_tpu_torch.serving.params import GenerateParams as TParams
from realtime_video_tpu_torch.serving.session import GenerationSession as TSession


def jpeg(rng, h=48, w=80) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def test_webcam_session_matches_jax(stacks):  # noqa: F811
    """Two webcam blocks at strength 0.6: 11 pushed frames resampled to 9 for
    block 0 (a fresh encode), 14 resampled to 12 for block 1 (streamed through
    the session's encoder cache); 48x80 JPEGs resized to 64x64."""
    config, jm, tm = stacks
    req = {**REQ, "num_blocks": 2, "webcam_mode": True, "strength": 0.6}
    jframes, tframes = [], []
    js = JSession(JParams(**req), config, models=jm,
                  frame_callback=lambda px, ids, ev: jframes.append(as_np(px)))
    noise_fn, state = jax_noise_stream(js.rng)
    ts = TSession(TParams(**req), config, models=tm,
                  noise=torch.from_numpy(as_np(js.noise)), noise_fn=noise_fn,
                  frame_callback=lambda px, ids, ev: tframes.append(as_np(px)))
    assert ts.params.strength == js.params.strength == 0.6
    assert list(ts.denoising_step_list) == list(js.denoising_step_list)
    rng = np.random.default_rng(11)
    for block, pushed in enumerate((11, 14)):
        for _ in range(pushed):
            frame = jpeg(rng)
            js.push_frame(frame, request_id="r")
            ts.push_frame(frame, request_id="r")
        assert ts.generate_block_internal(tm) is not None
        assert js.generate_block_internal(jm) is not None
        assert ts.frame_queue.empty() and js.frame_queue.empty()
        assert ts.encode_vae_cache is not None
    assert ts.generate_block_internal(tm) is None  # the block budget is spent
    assert_latents_match(js, ts)
    assert_same_key(state, js)
    J, T = np.concatenate(jframes, 1), np.concatenate(tframes, 1)
    assert J.shape == T.shape == (1, 18, 3, 64, 64) and np.isfinite(T).all()
    assert float(np.abs(J - T).mean()) < 3e-2
    assert ts.total_frames_sent == js.total_frames_sent == 18


def test_webcam_session_ends_when_disposed(stacks):  # noqa: F811
    """A webcam block waiting for frames returns None once the session is
    disposed (the server disposes it when the socket closes)."""
    import threading

    config, _, tm = stacks
    ts = TSession(TParams(**{**REQ, "webcam_mode": True}), config, models=tm)
    ts.push_frame(jpeg(np.random.default_rng(0)))
    threading.Timer(0.2, ts.dispose).start()
    assert ts.generate_block_internal(tm) is None
    assert ts.block_idx == 0


def test_input_video_session_matches_jax(stacks, tmp_path):  # noqa: F811
    """A 33-frame 48x80 clip written by cv2: encoded into 9 latents that are
    mixed into the initial noise at strength 0.7; 9 // 3 - 1 = 2 blocks (the
    reference's arithmetic) of the 3 asked for."""
    cv2 = pytest.importorskip("cv2")
    config, jm, tm = stacks
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 16, (80, 48))
    rng = np.random.default_rng(5)
    base = rng.random((48, 80, 3))
    for i in range(33):
        writer.write((np.roll(base, i, axis=1) * 255).astype(np.uint8))
    writer.release()
    req = {**REQ, "input_video": path, "strength": 0.7}
    # the JAX session splits its seed's key for the initial noise, then for
    # the clip's noise: the port gets the first draw and the stream after it
    key, sub = jax.random.split(jax.random.PRNGKey(REQ["seed"]))
    shape = (1, 3 * REQ["num_blocks"], 16, 8, 8)
    noise0 = jax.random.normal(sub, shape, jnp.float32).astype(jnp.bfloat16)
    noise_fn, state = jax_noise_stream(key)
    jframes, tframes = [], []
    js = JSession(JParams(**req), config, models=jm,
                  frame_callback=lambda px, ids, ev: jframes.append(as_np(px)))
    ts = TSession(TParams(**req), config, models=tm,
                  noise=torch.from_numpy(as_np(noise0)), noise_fn=noise_fn,
                  frame_callback=lambda px, ids, ev: tframes.append(as_np(px)))
    assert ts.num_blocks == js.num_blocks == 2
    np.testing.assert_allclose(as_np(ts.noise), as_np(js.noise), rtol=2e-2, atol=5e-2)
    for s, m in ((js, jm), (ts, tm)):
        for _ in range(2):
            assert s.generate_block_internal(m) is not None
        assert s.generate_block_internal(m) is None
    assert_latents_match(js, ts)
    assert_same_key(state, js)
    J, T = np.concatenate(jframes, 1), np.concatenate(tframes, 1)
    assert J.shape == T.shape == (1, 18, 3, 64, 64) and np.isfinite(T).all()
    assert float(np.abs(J - T).mean()) < 3e-2
