"""The VAE split by image rows (`parallel/vae_sp.py`, `VAEWrapper(mesh=)`) on
the CPU, every shard on the CPU, at the JAX test's tiny config in f32:

  * the split decode (first chunk, then warm chunks) and encode (fresh T = 1,
    1 + 4, then a warm 4) at 2 and 4 shards against the unsplit ones, and
    each shard's cache against the unsplit cache cut along H: rtol 1e-5,
    atol 1e-5; the same with the upsamples phase-folded;
  * the split decode against the JAX wrapper's `mesh=` decode on 4 virtual
    CPU devices (GSPMD's halos), at docs/PARITY.md's rtol 2e-3 / atol 2e-4;
  * the int8 tier (the plain conv path): with static scales and with
    dynamic ones (the largest of the shards' scales), every conv's s8
    quanta over the shards equal the unsplit conv's; the decode agrees;
  * planted faults that must fail those checks: interior halos zeroed, and
    each shard quantising with its own dynamic scale; a latent height that
    does not divide by the shard count raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from realtime_video_tpu.config import VAEConfig as JVAEConfig
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu_torch.config import VAEConfig
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.ops import hopper_conv as hc
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax

JCFG = JVAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
CFG = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-3, atol=2e-4)
#: latents [1, 3, z, h, w]: h 8 splits over 2 and 4 shards
Z_SHAPE = (1, 3, CFG.z_dim, 8, 6)


def numpy_vae_tree(seed: int):
    """Random numpy weights in init_vae_params' structure (eval_shape: an
    eager JAX init costs tens of seconds here), every weight nonzero."""
    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, JCFG, jnp.float32),
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
    np_tree = numpy_vae_tree(7)
    return np_tree, vae_params_from_jax(np_tree)


def latents(seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=Z_SHAPE).astype(np.float32))


def pixels(t, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, size=(1, t, 3, 64, 48)).astype(np.float32))


def stream_decode(vae, z):
    """First chunk (latent 0), then warm chunks of one latent each: the
    serving loop's decode. Returns (pixel list, cache after each call)."""
    out, caches, cache = [], [], None
    for i in range(z.shape[1]):
        px, cache = vae.decode_block(z[:, i:i + 1], cache)
        out.append(px)
        caches.append(cache)
    return out, caches


def joined_cache(split_cache):
    """The shards' caches joined along H, entry by entry."""
    return [torch.cat(entries, dim=1) for entries in zip(*split_cache)]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_upsample"])
@pytest.mark.parametrize("n", [2, 4])
def test_split_decode_and_caches_match_unsplit(trees, n, fused):
    _, tp = trees
    if fused:
        tp = tvae.fuse_decoder_upsample(tp)
    z = latents()
    want, want_caches = stream_decode(VAEWrapper(CFG, tp), z)
    split = VAEWrapper(CFG, tp, mesh=["cpu"] * n)
    got, got_caches = stream_decode(split, z)
    assert [g.shape for g in got] == [(1, 1, 3, 64, 48)] + [(1, 4, 3, 64, 48)] * 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    for gc, wc in zip(got_caches, want_caches):
        assert len(gc) == n and all(len(c) == len(wc) for c in gc)
        for g, w in zip(joined_cache(gc), wc):
            torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_split_encode_and_caches_match_unsplit(trees, n):
    _, tp = trees
    base, split = VAEWrapper(CFG, tp), VAEWrapper(CFG, tp, mesh=["cpu"] * n)
    px = pixels(9)
    for vae_args in ((px[:, :1],), (px[:, :5],)):  # fresh T = 1 (the re-encode), 1 + 4
        torch.testing.assert_close(split.encode_stream(*vae_args)[0],
                                   base.encode_stream(*vae_args)[0], **TOL)
    want, want_cache = base.encode_stream(px[:, :5])
    got, got_cache = split.encode_stream(px[:, :5])
    for g, w in zip(joined_cache(got_cache), want_cache):
        torch.testing.assert_close(g, w, **TOL)
    want2, _ = base.encode_stream(px[:, 5:], want_cache)  # a warm 4
    got2, _ = split.encode_stream(px[:, 5:], got_cache)
    assert got2.shape == (1, 1, CFG.z_dim, 8, 6)
    torch.testing.assert_close(got2, want2, **TOL)


def test_split_decode_matches_jax_mesh_decode(trees):
    """The port's 4-shard decode against JAX's GSPMD-sharded one (H split
    over an "sp" mesh of 4 virtual CPU devices): first and warm chunk."""
    np_tree, tp = trees
    jv = JVAE(cfg=JCFG, params=jax.tree.map(jnp.asarray, np_tree),
              mesh=Mesh(np.array(jax.devices()[:4]), ("sp",)))
    split = VAEWrapper(CFG, tp, mesh=["cpu"] * 4)
    z = latents(3)
    jpx, jcache = jv.decode_block(jnp.asarray(z[:, :1].numpy()))
    tpx, tcache = split.decode_block(z[:, :1])
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), **JAX_TOL)
    jpx, _ = jv.decode_block(jnp.asarray(z[:, 1:].numpy()), jcache)
    tpx, _ = split.decode_block(z[:, 1:], tcache)
    assert tpx.shape == (1, 8, 3, 64, 48)
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), **JAX_TOL)


def no_halo(self, xs, above, below):
    """The planted fault: every shard reads zeros for its neighbours' rows
    (the conv's edge padding on both sides of every shard)."""
    return [(x, (above, below)) for x in xs]


def own_scales(self, ps, xs):
    """The planted fault: each shard quantises with its own dynamic scale."""
    return list(ps)


def test_no_halo_fault_fails_and_ragged_height_raises(trees, monkeypatch):
    _, tp = trees
    z = latents()
    want, _ = stream_decode(VAEWrapper(CFG, tp), z)
    split = VAEWrapper(CFG, tp, mesh=["cpu"] * 2)
    monkeypatch.setattr(tvae._Walk, "halo", no_halo)
    got, _ = stream_decode(split, z)
    monkeypatch.undo()
    for g, w in zip(got, want):  # the first chunk and the warm ones all fail
        assert float((g - w).abs().max()) > 100 * TOL["atol"]
    with pytest.raises(ValueError, match=r"\(1, 1, 8, 6, 16\) does not split over 3 row"):
        VAEWrapper(CFG, tp, mesh=["cpu"] * 3).decode_block(z[:, :1])
    with pytest.raises(ValueError, match="latent height 8 does not split over 3"):
        VAEWrapper(CFG, tp, mesh=["cpu"] * 3).encode_stream(pixels(1))
    with pytest.raises(ValueError, match="exclusive"):
        VAEWrapper(CFG, tp, device="cpu", mesh=["cpu"] * 2)


def record_quanta(monkeypatch, calls):
    """Every int8 conv input's s8 quanta, in call order."""
    real = hc.quantize

    def quantize(x, a_scale):
        xq = real(x, a_scale)
        calls.append(xq.clone())
        return xq

    monkeypatch.setattr(hc, "quantize", quantize)


def quanta_match(split_calls, unsplit_calls, n) -> bool:
    """Whether each conv's shard quanta, halo rows taken off, join into the
    unsplit conv's quanta (the shards run each conv in lockstep)."""
    assert len(split_calls) == n * len(unsplit_calls)
    for k, want in enumerate(unsplit_calls):
        shards = split_calls[k * n:(k + 1) * n]
        h = want.shape[1] // n
        # every shard but the first has a row above, unless the conv's only
        # halo is below (the stride-2 downsample: the last shard has none)
        below_only = shards[-1].shape[1] == h
        tops = [0 if s == 0 or below_only else 1 for s in range(n)]
        if not torch.equal(torch.cat([x[:, t:t + h] for x, t in zip(shards, tops)], dim=1),
                           want):
            return False
    return True


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_int8_split_quanta_equal_unsplit(trees, monkeypatch, static):
    _, tp = trees
    z = latents()
    scales = tvae.calibrate_vae_act_scales(CFG, tp, z.permute(0, 1, 3, 4, 2)[:, :2]) \
        if static else None
    q = tvae.quantize_vae_params(tp, act_scales=scales)
    n = 2
    unsplit_calls, split_calls = [], []
    record_quanta(monkeypatch, unsplit_calls)
    want, _ = stream_decode(VAEWrapper(CFG, q), z)
    monkeypatch.undo()
    record_quanta(monkeypatch, split_calls)
    split = VAEWrapper(CFG, q, mesh=["cpu"] * n)
    got, _ = stream_decode(split, z)
    assert len(unsplit_calls) > 30
    assert quanta_match(split_calls, unsplit_calls, n)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    if not static:  # each shard quantising with its own scale must fail both checks
        split_calls.clear()
        monkeypatch.setattr(tvae._Walk, "scales", own_scales)
        bad, _ = stream_decode(split, z)
        assert not quanta_match(split_calls, unsplit_calls, n)
        assert max(float((b - w).abs().max()) for b, w in zip(bad, want)) > 100 * TOL["atol"]
