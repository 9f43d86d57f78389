"""The port's streaming VAE against the JAX VAE at tiny dims on the CPU, in f32:
first and warm decode chunks with their cache tuples, the T=1 encode that
the anti-drift re-encode runs, and a streamed 1+4 / 4 encode. Same
parameters (converted from the JAX tree), same numpy inputs. Tolerance:
rtol 2e-3, atol 2e-4 (docs/PARITY.md's bar; atol for values near zero)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAE_CONFIGS
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax

CFG = VAE_CONFIGS["vae-tiny"]
TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def params():
    """Random numpy weights in the structure of init_vae_params (taken with
    eval_shape: an eager or jitted JAX init costs 20-45 s here). Every weight
    is nonzero, the zero-initialised attention projections included."""
    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, CFG, jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def fill(path, s):
        name = path[-1].key
        if name == "gamma":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    numpy_tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(jnp.asarray, numpy_tree), vae_params_from_jax(numpy_tree)


def close_tree(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_streaming_decode_first_and_warm_chunk_match(params):
    jp, tp = params
    z = np.random.default_rng(1).normal(size=(1, 3, 4, 6, CFG.z_dim)).astype(np.float32)
    jpx, jcache = jvae.decode_chunks(CFG, jp, jnp.asarray(z[:, :1]), None, first=True)
    tpx, tcache = tvae.decode_chunks(CFG, tp, torch.from_numpy(z[:, :1]), None, first=True)
    assert tpx.shape == (1, 1, 32, 48, 3)
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), **TOL)
    close_tree(tcache, jcache)
    for i in (1, 2):  # warm chunks: 4 frames each, caches carried
        jpx, jcache = jvae.decode_chunks(CFG, jp, jnp.asarray(z[:, i:i + 1]), jcache,
                                         first=False)
        tpx, tcache = tvae.decode_chunks(CFG, tp, torch.from_numpy(z[:, i:i + 1]), tcache,
                                         first=False)
        assert tpx.shape == (1, 4, 32, 48, 3)
        np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), **TOL)
        close_tree(tcache, jcache)


def test_single_frame_encode_matches(params):
    """The anti-drift re-encode: one fresh pixel frame (T=1 tap-skip)."""
    jp, tp = params
    px = np.random.default_rng(2).uniform(-1, 1, size=(1, 1, 32, 48, 3)).astype(np.float32)
    jz, jcache = jvae.encode_chunks(CFG, jp, jnp.asarray(px), None, stream=False)
    tz, tcache = tvae.encode_chunks(CFG, tp, torch.from_numpy(px), None, stream=False)
    assert tz.shape == (1, 1, 4, 6, CFG.z_dim)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    close_tree(tcache, jcache)


def test_chunked_and_streamed_encode_matches(params):
    """1 + 4 frames fresh, then 4 more on the warm cache (downsample3d time
    convs, strided temporal taps)."""
    jp, tp = params
    px = np.random.default_rng(4).uniform(-1, 1, size=(1, 9, 32, 48, 3)).astype(np.float32)
    jz, jcache = jvae.encode_chunks(CFG, jp, jnp.asarray(px[:, :5]), None, stream=False)
    tz, tcache = tvae.encode_chunks(CFG, tp, torch.from_numpy(px[:, :5]), None, stream=False)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    jz, jcache = jvae.encode_chunks(CFG, jp, jnp.asarray(px[:, 5:]), jcache, stream=True)
    tz, tcache = tvae.encode_chunks(CFG, tp, torch.from_numpy(px[:, 5:]), tcache, stream=True)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    close_tree(tcache, jcache)


def test_wrapper_layouts_match(params):
    """decode_block / encode_stream take [B, T, C, H, W] like the JAX wrapper."""
    jp, tp = params
    vae = VAEWrapper(CFG, tp)
    z = np.random.default_rng(5).normal(size=(1, 1, CFG.z_dim, 4, 6)).astype(np.float32)
    px, cache = vae.decode_block(torch.from_numpy(z))
    jpx, _ = jvae.decode_chunks(CFG, jp, jnp.asarray(z.transpose(0, 1, 3, 4, 2)), None)
    np.testing.assert_allclose(px.numpy(), np.asarray(jpx).transpose(0, 1, 4, 2, 3), **TOL)
    lat, _ = vae.encode_stream(px[:, :1])
    jz, _ = jvae.encode_chunks(CFG, jp, jpx[:, :1], None)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jz).transpose(0, 1, 4, 2, 3), **TOL)
    assert cache is not None and vae.dtype == torch.float32
