"""The attention kernel's int8 QK^T mode (K2-int8) and the skewed routes (K6a,
K6b), all in csrc/attention_sm90.cu, against their plain PyTorch versions, on
a card (marked `cuda`; skips on a host without one). This file imports no
JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_modes_cuda.py

The bound is `hopper_attention.agreement` (elementwise atol + rtol 1.6e-2,
relative Frobenius 1e-2), as for K1/K2; the int8 pre-pass's quanta must equal
the plain version's but for a share <= 1e-3 that may differ by 1 (the
segment means' summation order). Planted faults must fail the same checks:
one mean over the whole sequence, the last segment's k scales one row off
(int8, on keys that share an offset), and the last K and V ring stages
holding the previous tile (int8, and the skewed routes' launches).
"""
import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk

INV = 1.0 / hk.LOG2E  # feed the kernel's own pre-scaled q to both sides

# (name, lq, lk, lo, hi, scale, key offset)
WINDOW_CASES = [
    ("window_lo", 200, 1024, 100, 700, 1.0, 0.0),
    ("cross", 130, 512, 0, 512, 1.0, 0.0),
    ("three_segments", 312, 2336, 100, 2336, 1.0, 2.0),
    ("large_norm", 160, 640, 64, 600, 4.0, 0.0),
    ("image_cross_257", 130, 257, 0, 257, 1.0, 2.0),
]


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _inputs(dev, lq, lk, scale=1.0, offset=0.0, n=2):
    t = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)  # noqa: E731
    q = hk.prescale(t(rand(1, (1, lq, n, 128), scale)), 128 ** -0.5)
    k = rand(2, (1, lk, n, 128), scale) + offset * rand(7, (1, 1, n, 128))
    return q, t(k), t(rand(3, (1, lk, n, 128)))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["window_int8qk", "window_skew", "window_skew_staticmax"])
def test_window_modes_match_plain_on_gpu(route):
    dev = _device_or_skip()
    for name, lq, lk, lo, hi, scale, offset in WINDOW_CASES:
        q, k, v = _inputs(dev, lq, lk, scale, offset)
        got = hk.window_attention(q, k, v, lo, hi, scale=INV, route=route)
        if route == "window_int8qk":
            want = hk.window_attention_int8qk_plain(q, k, v, lo, hi, scale=INV)
            seg = hk.segment_rows(lk)
            quanta = hk.quanta_agreement(hk.int8_qk_prepass(q, k, seg, INV),
                                         hk.int8_qk_prepass_plain(q, k, seg, INV))
            assert quanta["within_tol"], (name, quanta)
        else:
            want = hk.window_attention_plain(q, k, v, lo, hi, scale=INV)
        res = hk.agreement(got, want, hk.sharp_atol(v) if scale > 1 else hk.ATOL)
        assert res["within_tol"], (route, name, res)


@pytest.mark.cuda
@pytest.mark.parametrize("frames,fsl,nfpb,local", [(6, 64, 3, None), (7, 64, 3, 2)])
def test_block_causal_int8qk_matches_plain_on_gpu(frames, fsl, nfpb, local):
    dev = _device_or_skip()
    L = frames * fsl
    q, k, v = _inputs(dev, L, L, offset=2.0)
    window = None if local is None else local * fsl
    got = hk.block_causal_attention(q, k, v, fsl * nfpb, window, scale=INV,
                                    route="block_causal_int8qk")
    want = hk.block_causal_attention_int8qk_plain(q, k, v, fsl * nfpb, window, scale=INV)
    res = hk.agreement(got, want)
    assert res["within_tol"], res


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["global_mean", "k_scale_shift", "int8_ring_stage",
                                   "skew_ring_stage", "skew_staticmax_ring_stage"])
def test_check_catches_planted_fault_on_gpu(fault):
    dev = _device_or_skip()
    lq, lk, lo, hi = 312, 2336, 100, 2336
    q, k, v = _inputs(dev, lq, lk, offset=2.0)
    seg = hk.segment_rows(lk)
    mode = hk._MODE_WINDOW
    if fault in ("global_mean", "k_scale_shift", "int8_ring_stage"):
        want = hk.window_attention_int8qk_plain(q, k, v, lo, hi, scale=INV)
        assert hk.agreement(hk._launch_int8(q, k, v, INV, mode, lo, hi, 1, lk, -1, seg=seg),
                            want)["within_tol"]
        if fault == "global_mean":
            bad = hk._launch_int8(q, k, v, INV, mode, lo, hi, 1, lk, -1, seg=lk)
        else:
            code = hk.FAULT_K_SCALE_SHIFT if fault == "k_scale_shift" \
                else hk.FAULT_STALE_RING_STAGE
            bad = hk._launch_int8(q, k, v, INV, mode, lo, hi, 1, lk, -1, seg=seg, fault=code)
    else:
        want = hk.window_attention_plain(q, k, v, lo, hi, scale=INV)
        maxima = hk.logit_bound_maxima(q, k, INV) if fault == "skew_staticmax_ring_stage" \
            else None
        bad = hk._launch_sm90(q, k, v, INV, maxima, mode, lo, hi, 1, lk, -1,
                              fault=hk.FAULT_STALE_RING_STAGE)
    assert not hk.agreement(bad, want)["within_tol"], fault


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [128 ** -0.5, 1.0])
def test_int8_prepass_folds_the_prescale_on_gpu(scale):
    """The pre-pass on raw q against the plain pre-pass of prescale(q): q8
    and sq bit for bit (the row quantiser alone, no segment mean); k's quanta
    within the segment-mean share."""
    dev = _device_or_skip()
    t = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)  # noqa: E731
    q, k = t(rand(5, (1, 300, 3, 128), 2.0)), t(rand(6, (1, 700, 3, 128)) + 1.5)
    seg = hk.segment_rows(700)
    got = hk.int8_qk_prepass(q, k, seg, scale)
    want = hk.int8_qk_quantize_plain(hk.prescale(q, scale), k, seg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[3].shape == want[3].shape
    assert hk.quanta_agreement(got, want)["within_tol"]
