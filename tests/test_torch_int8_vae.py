"""The port's int8 VAE tier against the JAX package's on the CPU, at tiny dims
in f32: the activation calibration (`calibrate_vae_act_scales`, decode and
encode), the quantised tree (`quantize_vae_params`, encoder included), its
and its carry-over through `utils/convert.py` (the whole int8 decode and
encode are in tests/test_torch_int8_vae_stream.py).

Bounds: calibration maxima rtol 1e-5 per path (f32 summation order); w_q
equal bit for bit, scales rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAE_CONFIGS
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax

CFG = VAE_CONFIGS["vae-tiny"]


def numpy_vae_tree(seed=3):
    """Random numpy weights in the structure of init_vae_params (eval_shape:
    an eager JAX init costs tens of seconds here)."""
    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, CFG, jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "gamma":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def trees():
    """The JAX calibration on a 2-latent decode and a 1-frame encode, and the
    JAX-quantised tree."""
    np_tree = numpy_vae_tree()
    jp = jax.tree.map(jnp.asarray, np_tree)
    r = np.random.default_rng(4)
    z = r.normal(size=(1, 2, 4, 6, CFG.z_dim)).astype(np.float32)
    px = r.uniform(-1, 1, size=(1, 1, 32, 48, 3)).astype(np.float32)
    jscales = jvae.calibrate_vae_act_scales(CFG, jp, jnp.asarray(z), jnp.asarray(px))
    jq = jax.device_get(jvae.quantize_vae_params(jp, act_scales=jscales))
    return np_tree, jp, z, px, jscales, jq


def test_calibration_matches_jax(trees):
    np_tree, _, z, px, jscales, _ = trees
    tscales = tvae.calibrate_vae_act_scales(CFG, vae_params_from_jax(np_tree),
                                            torch.from_numpy(z), torch.from_numpy(px))
    assert set(tscales) == set(jscales) and "/decoder/conv1" in tscales
    assert "/encoder/conv1" in tscales
    for path, amax in jscales.items():
        np.testing.assert_allclose(tscales[path], amax, rtol=1e-5, err_msg=path)


def _pairs(t, j, path=""):
    """(path, torch node, jax node) for every int8 node of the two trees."""
    if isinstance(j, dict):
        if "w_q" in j:
            yield path, t, j
        else:
            for k in j:
                yield from _pairs(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, list):
        for i, (a, b) in enumerate(zip(t, j)):
            yield from _pairs(a, b, f"{path}/{i}")


@pytest.mark.parametrize("static", [True, False])
def test_quantized_tree_matches_jax(trees, static):
    np_tree, jp, _, _, jscales, _ = trees
    scales = jscales if static else None
    jq = jax.device_get(jvae.quantize_vae_params(jp, act_scales=scales))
    tq = tvae.quantize_vae_params(vae_params_from_jax(np_tree), act_scales=scales)
    pairs = list(_pairs(tq, jq))
    assert len(pairs) > 10 and any(p.startswith("/encoder") for p, _, _ in pairs)
    for path, tn, jn in pairs:
        assert set(tn) == set(jn), path
        np.testing.assert_array_equal(tn["w_q"].numpy(), np.asarray(jn["w_q"]), err_msg=path)
        np.testing.assert_allclose(tn["scale"].numpy(), np.asarray(jn["scale"]), rtol=1e-6)
        if static:
            np.testing.assert_allclose(tn["a_scale"].numpy(), np.asarray(jn["a_scale"]),
                                       rtol=1e-6, err_msg=path)
    # 1x1 and time convs stay float
    time_convs = [u["time_conv"] for u in tq["decoder"]["upsamples"] if "time_conv" in u]
    assert "w" in tq["conv2"] and time_convs and all("w" in c for c in time_convs)


def test_int8_tree_carries_across_with_its_dtypes(trees):
    """utils/convert keeps w_q int8 and scale / a_scale f32 under a bf16
    `dtype`, while the float leaves take it."""
    *_, jq = trees
    tq = vae_params_from_jax(jq, dtype=torch.bfloat16)
    pairs = list(_pairs(tq, jq))
    for path, tn, jn in pairs:
        assert tn["w_q"].dtype == torch.int8, path
        assert tn["scale"].dtype == tn["a_scale"].dtype == torch.float32, path
        np.testing.assert_array_equal(tn["w_q"].numpy(), np.asarray(jn["w_q"]))
        np.testing.assert_array_equal(tn["scale"].numpy(), np.asarray(jn["scale"]))
        np.testing.assert_array_equal(tn["a_scale"].numpy(), np.asarray(jn["a_scale"]))
        assert tn["b"].dtype == torch.bfloat16
    assert tq["conv2"]["w"].dtype == torch.bfloat16
