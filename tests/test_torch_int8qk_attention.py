"""The port's int8 QK^T attention (K2-int8) against the JAX package's, on the
CPU in f32.

The JAX side is `pallas_attention.decode_attention` / `prefill_attention` with
`INT8_QK` set, its `_flash_kernel` run in TPU interpret mode as
tests/test_pallas_attention.py runs it; the port's side is its plain int8
version, which the Hopper kernel is held to on a card. Both must compute the
TPU kernel's arithmetic: k minus the mean of its bk-row segment (from row 0,
the zero pad of the last segment counted), per-row s8 quanta with scale
max|row| / 127 + 1e-8, and float(s32) * (sq * sk).

Tolerance: relative Frobenius error 5e-4, at least 10 times tighter than
the int8-vs-float gap (test_pallas_attention.py puts it near 1e-2 in max
abs; here it measures 9e-3 to 0.5 in relative Frobenius, and every case
asserts the factor of 10). Only the summation order of the segment means
differs between XLA and torch, so a quantum may move by 1 in rare elements;
one such move shifts one score by up to max|q| * sk and one output row by a
few 1e-4, which an elementwise bound that tight would not take. A variant
that subtracts one mean over the whole sequence, as SageAttention does, must
miss the tolerance: that pins the per-segment semantics.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_video_tpu.ops import pallas_attention as pat
from realtime_video_tpu_torch.ops import attention as tattn
from realtime_video_tpu_torch.ops import hopper_attention as hk

REL_FRO = 5e-4


def rel_fro(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def keys(seed, shape, offset):
    """Random keys plus a per-head offset shared by every row, so that the
    segment means matter (a diluted tail mean leaves most of it in)."""
    k = rand(seed, shape)
    return k + offset * rand(seed + 100, (1, 1, shape[2], shape[3]))


# (name, lq, lk, lo, hi, key offset, BK): a window with lo > 0 (one
# segment); three segments with a diluted tail (2304 = 2 x 1024 + 256) on
# keys that share an offset; cross-attention (one 512-row segment); and the
# same window with BK 256, four segments
WINDOW_CASES = [
    ("window", 200, 1024, 100, 700, 0.0, 1024),
    ("diluted_tail", 200, 2304, 300, 2304, 2.0, 1024),
    ("cross", 130, 512, 0, 512, 0.0, 1024),
    ("window_bk256", 200, 1024, 100, 700, 2.0, 256),
]


@pytest.fixture
def int8_on(monkeypatch):
    monkeypatch.setattr(pat, "INT8_QK", True)
    monkeypatch.setattr(hk, "INT8_QK", True)
    return monkeypatch


def global_mean_variant(q, k, v, valid):
    """One mean over the whole KV sequence (SageAttention's smoothing)."""
    qs = hk.prescale(q, q.shape[-1] ** -0.5)
    lk = k.shape[1]
    q8, sq, k8, sk = hk.int8_qk_quantize_plain(qs, k, lk)
    return hk.int8_qk_attention_plain(q8, sq, k8, sk, v, valid, q.dtype)


@pytest.mark.parametrize("case", WINDOW_CASES, ids=[c[0] for c in WINDOW_CASES])
def test_window_int8qk_matches_jax(int8_on, case):
    _, lq, lk, lo, hi, offset, bk = case
    int8_on.setattr(pat, "BK", bk)
    int8_on.setattr(hk, "BK", bk)
    n, d = 2, 128
    q, k, v = rand(1, (1, lq, n, d)), keys(2, (1, lk, n, d), offset), rand(3, (1, lk, n, d))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pat.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(lo, jnp.int32),
                                               jnp.asarray(hi, jnp.int32)))
        int8_on.setattr(pat, "INT8_QK", False)
        float_path = np.asarray(pat.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lo, jnp.int32),
            jnp.asarray(hi, jnp.int32)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert hk.window_route() == "window_int8qk" and not hk.static_max("window_int8qk")
    got = tattn.decode_attention(tq, tk, tv, lo, hi).numpy()
    assert rel_fro(got, want) <= REL_FRO
    gap = rel_fro(float_path, want)
    assert gap > 10 * REL_FRO, gap  # the tolerance is far below the int8 gap
    if lo == 0 and hi == lk:  # the unmasked entry (cross-attention) is the same call
        np.testing.assert_array_equal(tattn.attention(tq, tk, tv).numpy(), got)
    if bk < lk:  # more than one segment: the global mean differs
        sage = global_mean_variant(tq, tk, tv, hk._window_mask(lk, lo, hi, "cpu")).numpy()
        assert rel_fro(sage, want) > REL_FRO, "a global mean passes the per-segment check"


# (frames, frame_seqlen, nfpb, BK): 6 frames of 64 tokens in 3-frame blocks,
# one 384-row segment at the default BK, and three at BK 128
@pytest.mark.parametrize("frames,fsl,nfpb,bk", [(6, 64, 3, 1024), (6, 64, 3, 128)])
def test_block_causal_int8qk_matches_jax(int8_on, frames, fsl, nfpb, bk):
    int8_on.setattr(pat, "BK", bk)
    int8_on.setattr(hk, "BK", bk)
    L, n, d = frames * fsl, 2, 128
    q, k, v = rand(4, (1, L, n, d)), keys(5, (1, L, n, d), 2.0), rand(6, (1, L, n, d))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pat.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                block_tokens=fsl * nfpb))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert hk.block_causal_route() == "block_causal_int8qk"
    got = tattn.block_causal_attention(tq, tk, tv, fsl * nfpb).numpy()
    assert rel_fro(got, want) <= REL_FRO
    if bk < L:  # more than one segment: the global mean differs
        valid = hk.block_causal_mask(L, L, fsl * nfpb, L, None, "cpu")
        sage = global_mean_variant(tq, tk, tv, valid).numpy()
        assert rel_fro(sage, want) > REL_FRO


def test_quantizer_segments_and_scales():
    """The plain quantiser's segments, pad and scales, on numbers small
    enough to check by hand: a 3-row key in segments of 2 has its last
    segment's mean over one real row and one zero pad row."""
    k = torch.zeros((1, 3, 1, 4))
    k[0, :, 0, 0] = torch.tensor([1.0, 3.0, 5.0])
    q = torch.ones((1, 1, 1, 4))
    q8, sq, k8, sk = hk.int8_qk_quantize_plain(q, k, 2)
    # means: rows 0-1 -> 2, row 2 with its pad -> 2.5; k - mean = -1, 1, 2.5
    np.testing.assert_allclose(sk.flatten().numpy(),
                               np.float32([1, 1, 2.5]) / np.float32(127) + np.float32(1e-8))
    assert k8[0, :, 0, 0].tolist() == [-127, 127, 127]
    assert q8.flatten().tolist() == [127] * 4
    assert sq.shape == (1, 1, 1) and sk.shape == (1, 1, 3)

