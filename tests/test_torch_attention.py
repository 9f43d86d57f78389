"""The port's attention against the JAX package's, on the CPU in f32.

On a CPU tensor the port's entry points run the plain PyTorch versions that
sit beside the Hopper kernel; they are held against `xla_attention` and
against the Pallas kernels K1 (`_staticmax_kernel`) and K2 (`_flash_kernel`)
run in TPU interpret mode, as tests/test_pallas_attention.py runs them.
Tolerance: rtol 2e-3, atol 2e-3 (the Pallas tests' bar).

The kernel itself has no CPU form: tests/test_torch_kernels_cuda.py holds it
to the plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_video_tpu.ops import attention as jattn
from realtime_video_tpu.ops import pallas_attention as pat
from realtime_video_tpu_torch.ops import attention as tattn
from realtime_video_tpu_torch.ops import hopper_attention as hk

TOL = dict(rtol=2e-3, atol=2e-3)


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def window_mask(lk, lo, hi):
    pos = jnp.arange(lk)[None, :]
    return ((pos >= lo) & (pos < hi))[None, None]


# (name, lq, lk, n, d, lo, hi, scale): window with lo > 0, cross-attention
# (lo 0, hi Lk), unpadded 1560-style lengths, and a large-norm input whose
# logit bound M >= 64 sends K1 to its running-max fallback
WINDOW_CASES = [
    ("window_lo", 200, 1024, 2, 128, 100, 700, 1.0),
    ("cross", 130, 512, 2, 128, 0, 512, 1.0),
    ("unpadded_1560", 312, 936, 2, 64, 0, 936, 1.0),
    ("large_norm", 160, 640, 2, 128, 64, 600, 4.0),
]


@pytest.mark.parametrize("case", WINDOW_CASES, ids=[c[0] for c in WINDOW_CASES])
def test_window_plain_matches_jax(case):
    _, lq, lk, n, d, lo, hi, scale = case
    q, k, v = rand(1, (1, lq, n, d), scale), rand(2, (1, lk, n, d), scale), rand(3, (1, lk, n, d))
    want_xla = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask=window_mask(lk, lo, hi))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = pat.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lo, jnp.int32),
                                           jnp.asarray(hi, jnp.int32))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn.decode_attention(tq, tk, tv, lo, hi).numpy()
    np.testing.assert_allclose(got, np.asarray(want_xla), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)
    if lo == 0 and hi == lk:  # the unmasked entry (cross-attention) is the same call
        np.testing.assert_allclose(tattn.attention(tq, tk, tv).numpy(), got, rtol=0, atol=0)


def test_large_norm_case_trips_the_fallback():
    """The large-norm case really is above the static-max limit (both sides
    compute the bound the same way)."""
    _, lq, lk, n, d, _, _, scale = WINDOW_CASES[-1]
    q, k = rand(1, (1, lq, n, d), scale), rand(2, (1, lk, n, d), scale)
    tq = hk.prescale(torch.from_numpy(q), d ** -0.5)
    m_t = float(hk.logit_bound(tq, torch.from_numpy(k))[0])
    qp = pat._prescale(jnp.asarray(q), d ** -0.5)
    m_j = float(pat._logit_bound(qp, jnp.asarray(k))[0])
    assert m_t >= hk.STATIC_MAX_LIMIT
    np.testing.assert_allclose(m_t, m_j, rtol=1e-5)


# (frames, frame_seqlen, nfpb, local_frames): full blocks, a partial
# trailing block, and a partial block with a local window
BLOCK_CASES = [(6, 64, 3, None), (7, 64, 3, None), (7, 64, 3, 2)]


@pytest.mark.parametrize("frames,fsl,nfpb,local", BLOCK_CASES)
def test_block_causal_plain_matches_jax(frames, fsl, nfpb, local):
    L, n, d = frames * fsl, 2, 128
    q, k, v = rand(4, (1, L, n, d)), rand(5, (1, L, n, d)), rand(6, (1, L, n, d))
    mask = jattn.blockwise_causal_mask(frames, fsl, nfpb,
                                       local_attn_size=-1 if local is None else local)
    want_xla = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask=mask[None, None])
    window = None if local is None else local * fsl
    with pltpu.force_tpu_interpret_mode():
        want_pallas = pat.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            block_tokens=fsl * nfpb, local_window=window)
    got = tattn.block_causal_attention(*map(torch.from_numpy, (q, k, v)), fsl * nfpb,
                                       window).numpy()
    np.testing.assert_allclose(got, np.asarray(want_xla), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


@pytest.mark.parametrize("local", [-1, 2])
@pytest.mark.parametrize("independent_first_frame", [False, True])
def test_mask_builders_match(local, independent_first_frame):
    want = jattn.blockwise_causal_mask(5, 4, 2, local_attn_size=local,
                                       independent_first_frame=independent_first_frame)
    got = tattn.blockwise_causal_mask(5, 4, 2, local_attn_size=local,
                                      independent_first_frame=independent_first_frame)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tattn.frame_block_ends(20, 4, 2).numpy(),
                                  np.asarray(jattn.frame_block_ends(20, 4, 2)))
    np.testing.assert_array_equal(
        tattn.decode_window_mask(3, 40, 8, 30, 16).numpy(),
        np.asarray(jattn.decode_window_mask(3, 40, jnp.asarray(8), jnp.asarray(30), 16)))


def test_plain_versions_count_no_cuda_calls_on_cpu():
    hk.reset_launch_counts()
    q = torch.from_numpy(rand(7, (1, 8, 2, 64)))
    tattn.decode_attention(q, q, q, 0, 8)
    tattn.block_causal_attention(q, q, q, 4)
    assert hk.LAUNCHES == {r: 0 for r in
                           hk.WINDOW_ROUTES + hk.BLOCK_CAUSAL_ROUTES + hk.BACKWARD_KEYS}
    assert set(hk.LAUNCHES) == {"window", "block_causal", "window_int8qk",
                                "block_causal_int8qk", "window_skew", "window_skew_staticmax",
                                "window_bwd", "block_causal_bwd"}
    assert hk.PLAIN_ON_CUDA == {"window": 0, "block_causal": 0}


def test_dense_mask_attention_matches_xla():
    q, k, v = rand(8, (1, 24, 2, 32)), rand(9, (1, 24, 2, 32)), rand(10, (1, 24, 2, 32))
    mask = np.random.default_rng(11).random((24, 24)) > 0.3
    mask[np.arange(24), np.arange(24)] = True
    want = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=jnp.asarray(mask)[None, None])
    got = tattn.attention(*map(torch.from_numpy, (q, k, v)),
                          mask=torch.from_numpy(mask)[None, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
