"""Video ingest of the port's session against the JAX session on the CPU at tiny
dims: the bicubic resize against `jax.image.resize`, `encode_video_latent`
(fresh and streamed) in f32, and whole sessions with a start frame or resume
latents. Parameters come from one JAX tree, carried across
(`wan_params_from_jax`, `vae_params_from_jax`); every random draw of the
port's session is fed the JAX session's own `jax.random` stream.

Bars: the resize max abs 5e-5 (both sides run Keys' cubic with a = -0.5 in
f32, widened when shrinking); `encode_video_latent` relative Frobenius 1e-3
in f32 (the JAX encoder computes in its input's dtype, so the function's bf16
cast of the frames is lifted on both sides);
sessions at the t2v session's bf16 bars (tests/test_torch_session.py):
latents atol 5e-2 + rtol 2e-2, pixels mean abs difference < 3e-2."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_session import REQ, VAEC, numpy_tree, stacks  # noqa: F401 (fixture)

from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu.serving import session as jsession
from realtime_video_tpu.serving.params import GenerateParams as JParams
from realtime_video_tpu.serving.session import GenerationSession as JSession
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper as TVAE
from realtime_video_tpu_torch.serving import session as tsession
from realtime_video_tpu_torch.serving.params import GenerateParams as TParams
from realtime_video_tpu_torch.serving.session import GenerationSession as TSession
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax


def rel_fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_noise_stream(key):
    """A NoiseFn that splits `key` as the JAX session does for each draw;
    state["k"] is the key after the draws so far."""
    state = {"k": key}

    def draw(shape, dtype, device):
        state["k"], sub = jax.random.split(state["k"])
        nz = jax.random.normal(sub, shape, jnp.float32).astype(jnp.bfloat16)
        return torch.from_numpy(np.array(nz.astype(jnp.float32))).to(device, dtype)

    return draw, state


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("src, dst", [((720, 1280), (480, 832)), ((480, 640), (480, 832)),
                                      ((64, 64), (96, 160))])
def test_bicubic_resize_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(sum(src))
    frames = rng.uniform(-1.0, 1.0, size=(2, 3, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(frames), (2, 3, *dst), method="bicubic"))
    got = tsession.resize_bicubic(torch.from_numpy(frames), *dst).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 5e-5


@pytest.fixture(scope="module")
def f32_vaes():
    vae_np, _ = numpy_tree(lambda k: jvae.init_vae_params(k, VAEC, jnp.float32), 4)
    jv = JVAE(cfg=VAEC, params=jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), vae_np))
    tv = TVAE(VAEC, vae_params_from_jax(vae_np, dtype=torch.float32))
    return jv, tv


class _F32Jnp:
    """jax.numpy with `bfloat16` read as float32: lifts the JAX function's
    bf16 cast of the resized frames, so that its encoder computes in f32."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


@pytest.mark.parametrize("stream", [False, True])
def test_encode_video_latent_matches_jax(f32_vaes, stream, monkeypatch):
    """9 frames of 40x72 resized to 64x64 and encoded fresh; with `stream`, 8
    more continue that encode through its cache. In f32: the JAX encoder
    computes in its input's dtype, so the frames' bf16 cast is lifted on both
    sides (the bf16 form runs in every session test)."""
    jv, tv = f32_vaes
    monkeypatch.setattr(jsession, "jnp", _F32Jnp())
    rng = np.random.default_rng(7)
    first = rng.uniform(-1, 1, size=(9, 3, 40, 72)).astype(np.float32)
    more = rng.uniform(-1, 1, size=(8, 3, 40, 72)).astype(np.float32)
    kw = dict(height=64, width=64)
    jl, jc = jsession.encode_video_latent(jv, None, frames=first, **kw)
    tl, tc = tsession.encode_video_latent(tv, None, frames=first, dtype=torch.float32, **kw)
    if stream:
        jl, _ = jsession.encode_video_latent(jv, jc, frames=more, stream=True, **kw)
        tl, _ = tsession.encode_video_latent(tv, tc, frames=more, stream=True,
                                             dtype=torch.float32, **kw)
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32
    assert tuple(tl.shape) == jl.shape == ((2 if stream else 3), 16, 8, 8)
    assert rel_fro(as_np(tl), as_np(jl)) <= 1e-3


def start_sessions(config, jm, tm, **fields):
    """The same request on both sides; the port gets the JAX session's
    initial noise and the rest of its key stream."""
    jframes, tframes = [], []
    req = {**REQ, **fields}
    js = JSession(JParams(**req), config, models=jm,
                  frame_callback=lambda px, ids, ev: jframes.append(as_np(px)))
    noise_fn, state = jax_noise_stream(js.rng)
    ts = TSession(TParams(**req), config, models=tm,
                  noise=torch.from_numpy(as_np(js.noise)), noise_fn=noise_fn,
                  frame_callback=lambda px, ids, ev: tframes.append(as_np(px)))
    return js, ts, jframes, tframes, state


def assert_latents_match(js, ts):
    assert ts.current_start_frame == js.current_start_frame
    np.testing.assert_allclose(as_np(ts.all_latents), as_np(js.all_latents),
                               rtol=2e-2, atol=5e-2)


def assert_same_key(state, js):
    """The port's session drew as many times as the JAX session split its key."""
    assert np.array_equal(np.asarray(state["k"]), np.asarray(js.rng))


def test_start_frame_session_matches_jax(stacks, tmp_path):  # noqa: F811
    """A start frame (a PNG path, as tests/test_session.py:192-222 sends it):
    encoded into 3 resume latents that block 0 takes as context; with 2
    blocks of budget the second block ends the session."""
    from PIL import Image

    config, jm, tm = stacks
    path = tmp_path / "start.png"
    Image.fromarray((np.random.default_rng(3).random((48, 80, 3)) * 255).astype(np.uint8)
                    ).save(path)
    js, ts, jframes, tframes, state = start_sessions(
        config, jm, tm, start_frame=str(path), num_blocks=2)
    assert tuple(ts.resume_latents.shape) == js.resume_latents.shape == (1, 3, 16, 8, 8)
    np.testing.assert_allclose(as_np(ts.resume_latents), as_np(js.resume_latents),
                               rtol=2e-2, atol=5e-2)
    for s, m in ((js, jm), (ts, tm)):
        assert s.generate_block_internal(m) is not None
        assert s.generate_block_internal(m) is None  # the resume latents took half the budget
    assert_latents_match(js, ts)
    assert_same_key(state, js)
    J, T = np.concatenate(jframes, 1), np.concatenate(tframes, 1)
    assert J.shape == T.shape == (1, 6, 3, 64, 64) and np.isfinite(T).all()
    assert float(np.abs(J - T).mean()) < 3e-2
    assert ts.total_frames_sent == js.total_frames_sent == 6


@pytest.mark.parametrize("tz, num_blocks", [(3, 3), (6, 2)])
def test_resume_latents_session_matches_jax(stacks, tz, num_blocks):  # noqa: F811
    """.npy resume latents [Tz, 16, 8, 8]: 3 of them are block 0's context and
    the session runs 2 more blocks; 6 of them exhaust a 2-block budget, so
    block 0 ends the session with nothing generated
    (tests/test_session.py:256-271)."""
    config, jm, tm = stacks
    arr = np.random.default_rng(tz).normal(size=(tz, 16, 8, 8)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, arr)
    js, ts, jframes, tframes, state = start_sessions(
        config, jm, tm, resume_latents=buf.getvalue(), num_blocks=num_blocks)
    produced = 0
    for _ in range(num_blocks):
        j_out = js.generate_block_internal(jm)
        t_out = ts.generate_block_internal(tm)
        assert (j_out is None) == (t_out is None)
        produced += t_out is not None
    assert produced == num_blocks - tz // 3
    assert ts.current_start_frame == js.current_start_frame == 3 * num_blocks
    np.testing.assert_allclose(as_np(ts.all_latents[:, :tz]), arr[None].astype(np.float32),
                               rtol=1e-2, atol=1e-2)
    assert_latents_match(js, ts)
    if produced:
        J, T = np.concatenate(jframes, 1), np.concatenate(tframes, 1)
        assert J.shape == T.shape == (1, 6 + 12 * (produced - 1), 3, 64, 64)
        assert float(np.abs(J - T).mean()) < 3e-2
    else:
        assert jframes == tframes == []
    assert_same_key(state, js)
