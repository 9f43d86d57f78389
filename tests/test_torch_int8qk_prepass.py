"""The int8 QK^T pre-pass on raw q (K2-int8's, csrc/attention_sm90.cu), held on
the CPU (the kernel itself runs only on a card:
tests/test_torch_attention_modes_cuda.py).

The pre-pass folds the prescale in: it forms bf16(q * bf16(scale * log2 e))
before each q row's max and quanta, so its plain version fed raw q must give
the quanta and scales of `int8_qk_quantize_plain(prescale(q, scale), k, seg)`
bit for bit, and the attention on them must agree with the JAX kernel in
interpret mode as tests/test_torch_int8qk_attention.py checks it (relative
Frobenius error 5e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_video_tpu.ops import pallas_attention as pat
from realtime_video_tpu_torch.ops import hopper_attention as hk

REL_FRO = 5e-4


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("lq, lk, seg, scale, dtype", [
    (33, 300, 128, 128 ** -0.5, torch.bfloat16),
    (64, 1024, 1024, 0.3, torch.bfloat16),
    (20, 700, 256, 128 ** -0.5, torch.float32),
])
def test_prepass_plain_folds_the_prescale(lq, lk, seg, scale, dtype):
    q = torch.from_numpy(rand(lq, (1, lq, 2, 128), 3.0)).to(dtype)
    k = torch.from_numpy(rand(lk, (1, lk, 2, 128)) + 1.5).to(dtype)
    want = hk.int8_qk_quantize_plain(hk.prescale(q, scale), k, seg)
    for got in (hk.int8_qk_prepass_plain(q, k, seg, scale), hk.int8_qk_prepass(q, k, seg, scale)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    # the kernel's factor: one rounding of the exact product, as prescale
    if dtype == torch.bfloat16:
        folded = (q.float() * hk.qscale(scale)).to(torch.bfloat16)
        assert torch.equal(folded.view(torch.int16), hk.prescale(q, scale).view(torch.int16))


@pytest.mark.parametrize("lo, hi, offset", [(100, 700, 2.0), (0, 512, 0.0)])
def test_attention_on_the_prepass_matches_jax(monkeypatch, lo, hi, offset):
    monkeypatch.setattr(pat, "INT8_QK", True)
    monkeypatch.setattr(hk, "INT8_QK", True)
    lq, lk, n, d = 96, max(hi, 512), 2, 128
    q, v = rand(1, (1, lq, n, d)), rand(3, (1, lk, n, d))
    k = rand(2, (1, lk, n, d)) + offset * rand(9, (1, 1, n, d))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pat.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(lo, jnp.int32),
                                               jnp.asarray(hi, jnp.int32)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    quanta = hk.int8_qk_prepass(tq, tk, hk.segment_rows(lk), d ** -0.5)
    got = hk.int8_qk_attention_plain(*quanta, tv, hk._window_mask(lk, lo, hi, "cpu"),
                                     tq.dtype).numpy()
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) <= REL_FRO
