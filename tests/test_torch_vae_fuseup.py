"""The upsample phase fold (`vae.fuse_decoder_upsample`, `RTV_VAE_FUSEUP`) on the
CPU, at the JAX fold test's config (tests/test_vae.py:78-118):

  * the fused streaming decode (first chunk, then a warm one) against the
    nearest-2x + conv decode, f32, rtol 1e-5 / atol 1e-5;
  * the port's fold of a converted tree against JAX's fold, converted:
    equal bit for bit (bf16-representable weights: every folded tap sums at
    most 4 of them, exactly, in either order);
  * the int8 fused decode against the float decode: mean error < 0.02, max
    < 0.25, the JAX test's bars;
  * the wrapper folds a float tree under RTV_VAE_FUSEUP=1, leaves it as it
    is without, and passes an int8 tree through untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAEConfig as JVAEConfig
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu_torch.config import VAEConfig
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax

JCFG = JVAEConfig(dim=16, z_dim=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1)
CFG = VAEConfig(dim=16, z_dim=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def trees():
    """bf16-representable f32 numpy weights in init_vae_params' structure."""
    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, JCFG, jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)

    def fill(path, s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        arr = rng.normal(size=s.shape) / np.sqrt(fan_in)
        if path[-1].key == "gamma":
            arr = 1.0 + 0.1 * rng.normal(size=s.shape)
        return np.asarray(jnp.asarray(arr, jnp.bfloat16).astype(jnp.float32))

    np_tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return np_tree, vae_params_from_jax(np_tree)


def latents(t):
    return torch.from_numpy(np.random.default_rng(12).normal(
        size=(1, t, 6, 8, CFG.z_dim)).astype(np.float32))


def test_fused_decode_matches_unfused(trees):
    _, tp = trees
    fused = tvae.fuse_decoder_upsample(tp)
    ups = [p for p in fused["decoder"]["upsamples"] if "conv" in p]
    assert len(ups) == 3 and all(p["conv"]["w"].shape[-1] == 2 * p["conv"]["w"].shape[2]
                                 for p in ups)
    z = latents(3)
    want0, wc = tvae.decode_chunks(CFG, tp, z[:, :1], None, first=True)
    got0, gc = tvae.decode_chunks(CFG, fused, z[:, :1], None, first=True)
    torch.testing.assert_close(got0, want0, **TOL)
    want1, _ = tvae.decode_chunks(CFG, tp, z[:, 1:], wc, first=False)
    got1, _ = tvae.decode_chunks(CFG, fused, z[:, 1:], gc, first=False)
    assert got1.shape == (1, 8, 48, 64, 3)
    torch.testing.assert_close(got1, want1, **TOL)


def test_fold_matches_jax_fold(trees):
    np_tree, tp = trees
    want = vae_params_from_jax(jax.tree.map(np.asarray, jvae.fuse_decoder_upsample(
        jax.tree.map(jnp.asarray, np_tree))))
    got = tvae.fuse_decoder_upsample(tp)
    got_leaves = list(tvae._walk_paths(got))
    want_leaves = dict(tvae._walk_paths(want))
    assert [p for p, _ in got_leaves] == list(want_leaves)
    for path, node in got_leaves:
        for k, v in node.items():
            if torch.is_tensor(v):
                assert torch.equal(v, want_leaves[path][k]), f"{path}/{k}"


def test_int8_fused_decode_composes(trees):
    _, tp = trees
    fused_q = tvae.quantize_vae_params(tvae.fuse_decoder_upsample(tp))
    assert fused_q["decoder"]["upsamples"][2]["conv"]["w_q"].shape[-1] == 4 * 32
    z = latents(2)
    want, _ = tvae.decode_chunks(CFG, tp, z, None, first=True)
    got, _ = tvae.decode_chunks(CFG, fused_q, z, None, first=True)
    err = (got - want).abs()
    assert float(err.mean()) < 0.02, float(err.mean())
    assert float(err.max()) < 0.25, float(err.max())


def test_wrapper_folds_float_trees_only(trees, monkeypatch):
    _, tp = trees
    co = tp["decoder"]["upsamples"][2]["conv"]["w"].shape[-1]
    monkeypatch.delenv("RTV_VAE_FUSEUP", raising=False)
    assert VAEWrapper(CFG, tp).params["decoder"]["upsamples"][2]["conv"]["w"].shape[-1] == co
    monkeypatch.setenv("RTV_VAE_FUSEUP", "1")
    vae = VAEWrapper(CFG, tp)
    assert vae.params["decoder"]["upsamples"][2]["conv"]["w"].shape[-1] == 4 * co
    z = latents(1).permute(0, 1, 4, 2, 3)
    torch.testing.assert_close(vae.decode_block(z)[0],
                               tvae.decode_chunks(CFG, tp, latents(1))[0].permute(0, 1, 4, 2, 3),
                               **TOL)
    q = tvae.quantize_vae_params(tp)
    conv = q["decoder"]["upsamples"][2]["conv"]
    assert VAEWrapper(CFG, q).params["decoder"]["upsamples"][2]["conv"] is conv
