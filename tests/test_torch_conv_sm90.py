"""What surrounds the wgmma conv kernel (K4/K5, csrc/conv_sm90.cu), held on the
CPU (the kernel itself runs only on a card: tests/test_torch_int8_kernels_cuda.py):

  * the int8 VAE weights from `quantize_vae_params` and `vae_params_from_jax`
    are [kt, 3, 3, C, Co] views of [Co, kt, 3, 3, Cp] storage (Cp: C padded
    to 32 with zero rows) holding the JAX quanta, and the wrapper's layout
    check refuses a Co-contiguous w_q;
  * the plain version of the fused dequantise is `_int8_conv2d`'s torch
    sequence bit for bit, and the port's int8 conv matches the JAX
    `_int8_conv2d` (rtol 1e-6, the f32 epilogue's rounding) at tiny dims:
    static and dynamic a_scale, stride 1 and 2;
  * the channel padding (C 3, C 16) and the ragged Co 3 give the unpadded
    result, and the padded layouts pass the kernel's checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAE_CONFIGS
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.ops import hopper_conv as hc
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax

CFG = VAE_CONFIGS["vae-tiny"]
PAD1 = ((1, 1), (1, 1))
DOWN = ((0, 1), (0, 1))


@pytest.fixture(scope="module")
def trees():
    """A numpy VAE tree in init_vae_params' structure (eval_shape, random
    leaves), the JAX-quantised tree, and the port's."""
    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, CFG, jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    np_tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    jq = jax.device_get(jvae.quantize_vae_params(jax.tree.map(jnp.asarray, np_tree)))
    tq = tvae.quantize_vae_params(vae_params_from_jax(np_tree))
    return jq, tq


def _int8_nodes(t, j, path=""):
    if isinstance(j, dict):
        if "w_q" in j:
            yield path, t, j
        else:
            for k in j:
                yield from _int8_nodes(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, list):
        for i, (a, b) in enumerate(zip(t, j)):
            yield from _int8_nodes(a, b, f"{path}/{i}")


@pytest.mark.parametrize("source", ["quantize_vae_params", "vae_params_from_jax"])
def test_int8_vae_weights_are_k_major_views_of_the_jax_quanta(trees, source):
    jq, tq = trees
    tree = tq if source == "quantize_vae_params" else vae_params_from_jax(jq)
    nodes = list(_int8_nodes(tree, jq))
    assert len(nodes) > 10 and any(p == "/encoder/conv1" for p, _, _ in nodes)
    cs = set()
    for path, tn, jn in nodes:
        w = tn["w_q"]
        kt, _, _, c, co = w.shape
        cp = hc.channel_pad(c, torch.int8)
        cs.add(c)
        assert w.dtype == torch.int8 and cp % 32 == 0
        assert w.stride() == (9 * cp, 3 * cp, cp, 1, kt * 9 * cp), (path, w.stride())
        assert w.untyped_storage().nbytes() == co * kt * 9 * cp, path  # stored once
        hc.check_weight_layout(w)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jn["w_q"]), err_msg=path)
        store = w.as_strided((co, kt * 9, cp), (kt * 9 * cp, cp, 1))
        assert not store[..., c:].any(), path  # the pad rows are zeros
    assert 3 in cs and CFG.z_dim in cs  # the encoder's and the decoder's first convs


def test_weight_layout_check_refuses_co_contiguous():
    w = torch.zeros((3, 3, 3, 64, 96), dtype=torch.int8)
    with pytest.raises(ValueError, match="k_major"):
        hc.check_weight_layout(w)  # Co contiguous: the JAX layout as stored by numpy
    with pytest.raises(ValueError, match=r"\[kt, 3, 3, C, Co\]"):
        hc.check_weight_layout(torch.zeros((3, 3, 64, 96), dtype=torch.int8))
    km = hc.k_major(w)
    hc.check_weight_layout(km)
    hc.check_weight_layout(km[2:])  # the T=1 tap-skip's slice keeps the layout
    with pytest.raises(ValueError, match="k_major"):  # C 3 unpadded: 3-byte taps
        hc.check_weight_layout(torch.zeros((8, 1, 3, 3, 3), dtype=torch.int8)
                               .permute(1, 2, 3, 4, 0))
    with pytest.raises(ValueError, match="pad_channels"):
        hc.check_input_layout(torch.zeros((1, 4, 4, 3), dtype=torch.int8))
    hc.check_input_layout(hc.pad_channels(torch.zeros((1, 4, 4, 3), dtype=torch.int8)))


def _params(kt, c, co, static, seed):
    rng = np.random.default_rng(seed)
    p = {"w_q": rng.integers(-127, 128, size=(kt, 3, 3, c, co)).astype(np.int8),
         "scale": rng.uniform(1e-3, 3e-3, size=co).astype(np.float32),
         "b": rng.normal(size=co).astype(np.float32)}
    if static:
        p["a_scale"] = np.float32(3.0 / 127.0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    tp["w_q"] = hc.k_major(tp["w_q"])
    return jp, tp


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("stride, padding", [((1, 1), PAD1), ((2, 2), DOWN)])
def test_fused_dequantise_is_the_torch_sequence_and_jax(static, stride, padding):
    jp, tp = _params(1, 8, 12, static, 11)
    x = torch.from_numpy((np.random.default_rng(12).normal(size=(2, 10, 12, 8)) * 1.5)
                         .astype(np.float32))
    a = tvae._act_scale(tp, x)
    yq = hc.conv3x3(hc.quantize(x, a), tp["w_q"], stride, padding)
    # models/vae.py::_int8_conv2d's torch sequence before the epilogue was fused
    want = ((yq.float() * (a * tp["scale"].float())) + tp["b"].float()).to(x.dtype)
    got = hc.dequantize_plain(yq, a, tp["scale"], tp["b"], x.dtype)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    fused = tvae._int8_conv2d(tp, x, stride, padding)
    assert torch.equal(fused.view(torch.int32), want.view(torch.int32))
    jw = dict(jp, w_q=jp["w_q"][0])  # the JAX function takes the tap-merged w_q
    np.testing.assert_allclose(fused.numpy(),
                               np.asarray(jvae._int8_conv2d(jw, jnp.asarray(x.numpy()),
                                                            stride, padding)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kt, c, co", [(1, 3, 16), (3, 16, 24), (3, 8, 3), (1, 16, 3)])
def test_padding_gives_the_unpadded_result(kt, c, co):
    """C 3 (the encoder's input), C 16 (the decoder's), Co 3 (its head):
    the padded layouts the kernel reads give the unpadded conv."""
    rng = np.random.default_rng(c * co)
    x = torch.from_numpy(rng.integers(-127, 128, size=(kt + 1, 7, 9, c)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(kt, 3, 3, c, co)).astype(np.int8))
    xp, wp = hc.pad_channels(x), hc.k_major(w)
    hc.check_input_layout(xp)
    hc.check_weight_layout(wp)
    assert xp.stride(2) == hc.channel_pad(c, torch.int8) and torch.equal(xp, x)
    assert torch.equal(wp, w)
    want = hc.conv3x3_plain(x, w)
    assert torch.equal(hc.conv3x3(xp, wp), want)
    # the quantise entry pads as the kernel's pre-pass does, with the same quanta
    xf = torch.from_numpy(rng.normal(size=(kt + 1, 7, 9, c)).astype(np.float32))
    a = torch.tensor(0.02)
    q = hc.quantize(xf, a)
    hc.check_input_layout(q)
    assert torch.equal(q, hm.quantize(xf, a))
