"""TAEHV, the preview tier's tiny autoencoder: the port (`models/taehv.py`)
against the JAX module on the CPU in f32, with the same random weights (a
numpy tree in the JAX layout, carried across by `taehv_params_from_jax`).

Decode and encode agree at relative Frobenius 1e-4, at T >= 4 so that
TPool's frame-major channel concat and TGrow's split of channels into
frames both run on several frames; a clip decoded (or encoded) in chunks
equals the whole clip within 1e-5; the checkpoint converter gives JAX's
tree bit for bit, an over-wide TGrow conv included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.models import taehv as jtaehv
from realtime_video_tpu_torch.models import taehv
from realtime_video_tpu_torch.utils.convert import taehv_params_from_jax

REL = 1e-4
CHUNK = 1e-5


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_shapes():
    return jax.eval_shape(lambda k: jtaehv.init_taehv_params(k), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def weights():
    """Random f32 weights in the JAX tree's structure (HWIO), twice the init's
    spread and with nonzero biases, so that deep layers stay far from zero."""
    rng = np.random.default_rng(0)

    def fill(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 16
        return (2.0 * rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    jp = jax.tree.map(fill, jax_shapes())
    return jax.tree.map(jnp.asarray, jp), taehv_params_from_jax(jp)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def test_init_has_the_jax_structure():
    tp = taehv.init_taehv_params(torch.Generator().manual_seed(0), "cpu")
    want = taehv_params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                              jax_shapes()))
    got_leaves = jax.tree_util.tree_leaves_with_path(tp)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(got_leaves, want_leaves))
    w = tp["decoder"][3]["c0"]["w"]  # uniform +-1/sqrt(9 * 512)
    assert float(w.abs().max()) <= 1 / np.sqrt(9 * 512) and float(w.std()) > 0


@pytest.mark.parametrize("frames", [3, 4])
def test_decode_matches_jax(weights, frames):
    jp, tp = weights
    z = np.random.default_rng(frames).normal(size=(1, frames, 16, 4, 4)).astype(np.float32)
    want, _ = jtaehv.taehv_decode(jp, jnp.asarray(z))
    got, state = taehv.taehv_decode(tp, _t(z))
    assert got.shape == (1, 4 * frames, 3, 32, 32) and len(state) == 9
    assert rel_fro(got.numpy(), want) < REL


@pytest.mark.parametrize("frames", [8, 16])
def test_encode_matches_jax(weights, frames):
    jp, tp = weights
    v = np.random.default_rng(frames).random(size=(1, frames, 3, 32, 32)).astype(np.float32)
    want, _ = jtaehv.taehv_encode(jp, jnp.asarray(v))
    got, state = taehv.taehv_encode(tp, _t(v))
    assert got.shape == (1, frames // 4, 16, 4, 4) and len(state) == 9
    assert rel_fro(got.numpy(), want) < REL


@pytest.mark.parametrize("chunks", [(1, 1, 1, 1), (3, 1)])
def test_chunked_decode_equals_the_whole_clip(weights, chunks):
    _, tp = weights
    z = _t(np.random.default_rng(7).normal(size=(1, 4, 16, 4, 4)))
    whole, _ = taehv.taehv_decode(tp, z)
    parts, state, start = [], None, 0
    for n in chunks:
        px, state = taehv.taehv_decode(tp, z[:, start:start + n], state)
        parts.append(px)
        start += n
    got = torch.cat(parts, dim=1)
    assert got.shape == whole.shape
    assert rel_fro(got.numpy(), whole.numpy()) < CHUNK


def test_chunked_encode_equals_the_whole_clip(weights):
    _, tp = weights
    v = _t(np.random.default_rng(8).random(size=(1, 8, 3, 32, 32)))
    whole, _ = taehv.taehv_encode(tp, v)
    z0, state = taehv.taehv_encode(tp, v[:, :4])
    z1, _ = taehv.taehv_encode(tp, v[:, 4:], state)
    assert rel_fro(torch.cat([z0, z1], dim=1).numpy(), whole.numpy()) < CHUNK


def _state_dict(rng) -> dict:
    """A taew2_1-style torch state dict (Sequential keys, OIHW weights) for
    the default plans, with decoder TGrow 7 twice as wide as its plan and a
    MemBlock carrying a 1x1 skip."""
    sd = {}

    def conv(name, co, ci, k, bias=True):
        sd[f"{name}.weight"] = torch.from_numpy(rng.normal(size=(co, ci, k, k)).astype(np.float32))
        if bias:
            sd[f"{name}.bias"] = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32))

    for prefix, plan in (("encoder", jtaehv.encoder_plan()), ("decoder", jtaehv.decoder_plan())):
        for i, spec in enumerate(plan):
            kind = spec[0]
            if kind in ("conv", "conv_s2"):
                conv(f"{prefix}.{i}", spec[2], spec[1], 3, spec[3])
            elif kind == "mem":
                conv(f"{prefix}.{i}.conv.0", spec[2], 2 * spec[1], 3)
                conv(f"{prefix}.{i}.conv.2", spec[2], spec[2], 3)
                conv(f"{prefix}.{i}.conv.4", spec[2], spec[2], 3)
            elif kind == "tpool":
                conv(f"{prefix}.{i}.conv", spec[1], spec[1] * spec[2], 1, False)
            elif kind == "tgrow":
                wide = 2 if (prefix, i) == ("decoder", 7) else 1
                conv(f"{prefix}.{i}.conv", spec[1] * spec[2] * wide, spec[1], 1, False)
    conv("encoder.4.skip", 64, 64, 1, False)
    return sd


def test_checkpoint_converter_is_bit_equal_to_jax():
    sd = _state_dict(np.random.default_rng(3))
    want = taehv_params_from_jax(jax.tree.map(np.asarray, jtaehv.convert_taehv_checkpoint(sd)))
    got = taehv.convert_taehv_checkpoint(sd)
    assert got["decoder"][7]["w"].shape == (256, 256, 1, 1)  # the last 256 of 512 kept
    assert torch.equal(got["decoder"][7]["w"], sd["decoder.7.conv.weight"][256:])
    assert "skip" in got["encoder"][4]
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("time_upscale, trim", [((True, True), 3), ((True, False), 1),
                                                ((False, False), 0)])
def test_frames_to_trim(time_upscale, trim):
    assert taehv.frames_to_trim(time_upscale) == jtaehv.frames_to_trim(time_upscale) == trim


def test_decode_work_counts_every_conv(weights, monkeypatch):
    """decode_work (the bound's operations and bytes) equals the MACs of the
    F.conv2d calls one decode makes, and the bytes of its inputs, weights,
    state and outputs."""
    _, tp = weights
    macs = []
    conv2d = torch.nn.functional.conv2d

    def counting(x, w, b=None, stride=1, padding=0):
        y = conv2d(x, w, b, stride, padding)
        macs.append(y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    monkeypatch.setattr(taehv.F, "conv2d", counting)
    z = torch.zeros((1, 3, 16, 4, 6))
    px, state = taehv.taehv_decode(tp, z)
    macs_counted, io_bytes = taehv.decode_work(3, 4, 6, itemsize=4)
    assert sum(macs) == macs_counted
    weights = sum(t.numel() for t in jax.tree_util.tree_leaves(tp["decoder"]))
    assert io_bytes == 4 * (z.numel() + weights + 2 * sum(s.numel() for s in state) + px.numel())
