"""Whole int8 streaming decodes and encodes of the port's VAE against the JAX
package's, on the same quantised parameters (the JAX `quantize_vae_params`
tree with static scales from a calibration, carried across), at tiny dims in
f32 on the CPU: the first and two warm decode chunks with their caches, the
T=1 anti-drift encode (tap-skip), and a 1 + 4 frame encode continued by 4
frames on the warm cache.

Bound: relative Frobenius error <= 1e-3, which leaves room for a rare
one-LSB quantum flip where upstream f32 sums, taken in another order, land on
the other side of a rounding boundary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAE_CONFIGS
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.ops import hopper_conv as hc
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax

CFG = VAE_CONFIGS["vae-tiny"]


@pytest.fixture(autouse=True)
def kernel_contract(monkeypatch):
    """Every conv the int8 VAE makes hands the kernel's wrapper s8 operands
    in the layouts the card's kernel requires (pixels 16 bytes apart, the
    K-major weight view), which the CPU's plain version would not need."""
    conv = hc.conv3x3
    calls = []

    def checked(x, w, *args, **kwargs):
        assert x.dtype == w.dtype == torch.int8
        hc.check_input_layout(x)
        hc.check_weight_layout(w)
        calls.append(1)
        return conv(x, w, *args, **kwargs)

    monkeypatch.setattr(hc, "conv3x3", checked)
    yield
    assert calls


def rel_fro(t, j):
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    return float(np.linalg.norm(t - j) / np.linalg.norm(j))


@pytest.fixture(scope="module")
def trees():
    """The JAX-quantised tree of random numpy weights in the structure of
    init_vae_params, with static scales from the port's calibration (itself
    held to the JAX calibration by tests/test_torch_int8_vae.py)."""
    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, CFG, jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def fill(path, s):
        if path[-1].key == "gamma":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    np_tree = jax.tree_util.tree_map_with_path(fill, shapes)
    r = np.random.default_rng(4)
    z = torch.from_numpy(r.normal(size=(1, 2, 4, 6, CFG.z_dim)).astype(np.float32))
    px = torch.from_numpy(r.uniform(-1, 1, size=(1, 1, 32, 48, 3)).astype(np.float32))
    scales = tvae.calibrate_vae_act_scales(CFG, vae_params_from_jax(np_tree), z, px)
    jq = jax.device_get(jvae.quantize_vae_params(jax.tree.map(jnp.asarray, np_tree),
                                                 act_scales=scales))
    return (jq,)


def test_int8_streaming_decode_matches_jax(trees):
    *_, jq = trees
    tq = vae_params_from_jax(jq)
    z = np.random.default_rng(5).normal(size=(1, 3, 2, 3, CFG.z_dim)).astype(np.float32)
    jpx, jcache = jvae.decode_chunks(CFG, jq, jnp.asarray(z[:, :1]), None, first=True)
    tpx, tcache = tvae.decode_chunks(CFG, tq, torch.from_numpy(z[:, :1]), None, first=True)
    assert tpx.shape == (1, 1, 16, 24, 3)
    assert rel_fro(tpx, jpx) < 1e-3
    for i in (1, 2):
        jpx, jcache = jvae.decode_chunks(CFG, jq, jnp.asarray(z[:, i:i + 1]), jcache,
                                         first=False)
        tpx, tcache = tvae.decode_chunks(CFG, tq, torch.from_numpy(z[:, i:i + 1]), tcache,
                                         first=False)
        assert tpx.shape == (1, 4, 16, 24, 3)
        assert rel_fro(tpx, jpx) < 1e-3
    assert len(tcache) == len(jcache)


def test_int8_encode_matches_jax(trees):
    """The T=1 anti-drift encode (tap-skip), then 1 + 4 frames fresh and 4
    more on the warm cache."""
    *_, jq = trees
    tq = vae_params_from_jax(jq)
    px = np.random.default_rng(6).uniform(-1, 1, size=(1, 9, 16, 24, 3)).astype(np.float32)
    jz, _ = jvae.encode_chunks(CFG, jq, jnp.asarray(px[:, :1]), None, stream=False)
    tz, _ = tvae.encode_chunks(CFG, tq, torch.from_numpy(px[:, :1]), None, stream=False)
    assert tz.shape == (1, 1, 2, 3, CFG.z_dim)
    assert rel_fro(tz, jz) < 1e-3
    jz, jcache = jvae.encode_chunks(CFG, jq, jnp.asarray(px[:, :5]), None, stream=False)
    tz, tcache = tvae.encode_chunks(CFG, tq, torch.from_numpy(px[:, :5]), None, stream=False)
    assert rel_fro(tz, jz) < 1e-3
    jz, _ = jvae.encode_chunks(CFG, jq, jnp.asarray(px[:, 5:]), jcache, stream=True)
    tz, _ = tvae.encode_chunks(CFG, tq, torch.from_numpy(px[:, 5:]), tcache, stream=True)
    assert rel_fro(tz, jz) < 1e-3
