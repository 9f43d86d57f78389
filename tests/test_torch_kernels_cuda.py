"""The hand-written CUDA attention kernel of the bf16 routes (csrc/attention_sm90.cu)
and its logit-bound pre-pass against their plain PyTorch versions, on a card
(marked `cuda`; skips on a host without one). This file imports no
JAX, so it runs on the GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Cases: the window with lo > 0, cross-attention (over 512 text tokens, and
over the 257 CLIP tokens of i2v: one live row in the last K tile), unpadded
lengths, the large-norm input that trips the running-max path, and
block-causal with a partial block and a local window. Planted faults in the window's edges, the
end of the last block, and a ring stage filled with the previous tile must
fail the same check.
"""
import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk

WINDOW_CASES = [
    ("window_lo", 200, 1024, 2, 128, 100, 700, 1.0),
    ("cross", 130, 512, 2, 128, 0, 512, 1.0),
    ("unpadded_1560", 312, 936, 2, 128, 0, 936, 1.0),
    ("large_norm", 160, 640, 2, 128, 64, 600, 4.0),
    ("image_cross_257", 130, 257, 2, 128, 0, 257, 1.0),
]
BLOCK_CASES = [(6, 64, 3, None), (7, 64, 3, None), (7, 64, 3, 2)]


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _t(dev, seed, shape, scale=1.0):
    return torch.from_numpy(rand(seed, shape, scale)).to(dev, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version in bf16 on the card, both
    modes, ragged lengths, lo > 0 and the large-norm fallback, under
    hk.agreement: elementwise atol + rtol 1.6e-2 (both sides round P and the
    output to bf16; atol 2e-3, or 2^-7 max|v| for the large-norm input's sharp
    softmax) and relative Frobenius error 1e-2."""
    dev = _device_or_skip()
    inv = 1.0 / hk.LOG2E  # feed the kernel's own pre-scaled q to both sides
    for name, lq, lk, n, d, lo, hi, scale in WINDOW_CASES:
        q = hk.prescale(_t(dev, 1, (1, lq, n, d), scale), d ** -0.5)
        k, v = _t(dev, 2, (1, lk, n, d), scale), _t(dev, 3, (1, lk, n, d))
        got = hk.window_attention(q, k, v, lo, hi, scale=inv)
        want = hk.window_attention_plain(q, k, v, lo, hi, scale=inv)
        res = hk.agreement(got, want, hk.sharp_atol(v) if scale > 1 else hk.ATOL)
        assert res["within_tol"], (name, res)
    for frames, fsl, nfpb, local in BLOCK_CASES:
        L = frames * fsl
        q = hk.prescale(_t(dev, 4, (1, L, 2, 128)), 128 ** -0.5)
        k, v = _t(dev, 5, (1, L, 2, 128)), _t(dev, 6, (1, L, 2, 128))
        window = None if local is None else local * fsl
        got = hk.block_causal_attention(q, k, v, fsl * nfpb, window, scale=inv)
        want = hk.block_causal_attention_plain(q, k, v, fsl * nfpb, window, scale=inv)
        res = hk.agreement(got, want)
        assert res["within_tol"], ((frames, fsl, nfpb, local), res)


@pytest.mark.cuda
def test_logit_bound_prepass_matches_plain_on_gpu():
    """The bound pre-pass's M against `logit_bound` on the pre-scaled q
    (relative 1e-5: only the order of the row sums differs)."""
    dev = _device_or_skip()
    for seed, (lq, lk, n, scale) in enumerate([(200, 1024, 2, 1.0), (160, 640, 2, 4.0)]):
        q, k = _t(dev, seed, (1, lq, n, 128), scale), _t(dev, seed + 7, (1, lk, n, 128), scale)
        got = hk.logit_bound_from_maxima(hk.logit_bound_maxima(q, k, 128 ** -0.5))
        want = hk.logit_bound(hk.prescale(q, 128 ** -0.5), k)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["lo+8", "hi-16", "kv_len-16", "stale_ring_stage"])
def test_check_catches_planted_fault_on_gpu(fault):
    """The same check fails a kernel that misses the tile straddling lo, the
    ragged tail past the last full tile, or the end of the last block, or
    whose last ring stage holds the previous tile."""
    dev = _device_or_skip()
    inv = 1.0 / hk.LOG2E
    if fault == "kv_len-16":
        L, bt = 7 * 64, 3 * 64
        q = hk.prescale(_t(dev, 4, (1, L, 2, 128)), 128 ** -0.5)
        k, v = _t(dev, 5, (1, L, 2, 128)), _t(dev, 6, (1, L, 2, 128))
        want = hk.block_causal_attention_plain(q, k, v, bt, scale=inv)
        got = hk._launch_sm90(q, k, v, inv, None, hk._MODE_BLOCK_CAUSAL, 0, L, bt, L - 16, -1)
    elif fault == "stale_ring_stage":
        lq, lk, lo, hi = 200, 1040, 100, 1040
        q = hk.prescale(_t(dev, 1, (1, lq, 2, 128)), 128 ** -0.5)
        k, v = _t(dev, 2, (1, lk, 2, 128)), _t(dev, 3, (1, lk, 2, 128))
        want = hk.window_attention_plain(q, k, v, lo, hi, scale=inv)
        got = hk._launch_sm90(q, k, v, inv, hk.logit_bound_maxima(q, k, inv), hk._MODE_WINDOW,
                              lo, hi, 1, lk, -1, fault=hk.FAULT_STALE_RING_STAGE)
    else:
        lq, lk, lo, hi = 200, 1040, 100, 1040
        q = hk.prescale(_t(dev, 1, (1, lq, 2, 128)), 128 ** -0.5)
        k, v = _t(dev, 2, (1, lk, 2, 128)), _t(dev, 3, (1, lk, 2, 128))
        want = hk.window_attention_plain(q, k, v, lo, hi, scale=inv)
        lo_f, hi_f = (lo + 8, hi) if fault == "lo+8" else (lo, hi - 16)
        got = hk.window_attention(q, k, v, lo_f, hi_f, scale=inv)
        assert hk.agreement(hk.window_attention(q, k, v, lo, hi, scale=inv),
                            want)["within_tol"]
    assert not hk.agreement(got, want)["within_tol"], fault
