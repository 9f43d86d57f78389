"""The hand-written fused int8 linear (K3, csrc/int8_mm.cu) and kt x 3 x 3 conv
(K4/K5, csrc/conv_sm90.cu) against their plain PyTorch versions on a card
(marked `cuda`; skips on a host without one). This file imports no JAX, so it
runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_kernels_cuda.py

Bounds: the int8 linear's quanta and s32 sums equal the plain version's, so
only the f32 epilogue's bf16 rounding may differ: within 1 bf16 ulp. The s8
conv's int32 sums must be equal element for element, its fused dequantise
epilogue equal bit for bit to the torch dequantise of those sums, and its
quantise pre-pass's quanta equal to the plain version's. The bf16 conv is held
by hopper_attention.agreement (elementwise atol 2e-3 + rtol 1.6e-2, relative
Frobenius error 1e-2: both sides sum bf16 products in f32, in different
orders, and round to bf16). Planted faults (the last K tile dropped, w_scale
one column off, the last ring stage holding the previous K tile; a halo row
zeroed, the last 32 bytes of channels dropped, a conv ring stage out of step,
tap dx = 2 reading tap dx = 1's rows of the shared A stage) must fail the
same checks. The kernels' weights are K-major views
(`hm.k_major`, `hc.k_major`); the other layouts are refused. Conv inputs
whose channels are not a multiple of 32 bytes are padded (`hc.pad_channels`,
as the quantise pre-pass writes them).
"""
import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.ops import hopper_conv as hc
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm

# (name, M, K, N, bias dtype or None, dynamic scale)
MM_CASES = [
    ("ragged_m", 300, 256, 192, torch.bfloat16, False),
    ("k_tiled", 200, 2304, 128, torch.float32, False),
    ("dynamic", 130, 512, 272, torch.bfloat16, True),
    ("no_bias", 77, 144, 64, None, False),
]
# (name, dtype, T, H, W, C, Co, kt, stride, padding)
CONV_CASES = [
    ("s8_kt3", torch.int8, 4, 12, 20, 64, 96, 3, (1, 1), ((1, 1), (1, 1))),
    ("s8_kt1_c3", torch.int8, 1, 16, 24, 3, 64, 1, (1, 1), ((1, 1), (1, 1))),
    ("s8_c16_co3", torch.int8, 3, 10, 14, 16, 3, 3, (1, 1), ((1, 1), (1, 1))),
    ("s8_stride2", torch.int8, 1, 16, 24, 32, 32, 1, (2, 2), ((0, 1), (0, 1))),
    ("s8_c96_ragged_rows", torch.int8, 3, 9, 13, 96, 192, 3, (1, 1), ((1, 1), (1, 1))),
    ("s8_co32", torch.int8, 1, 8, 12, 64, 32, 1, (1, 1), ((1, 1), (1, 1))),
    ("s8_c384_four_col_tiles", torch.int8, 3, 6, 20, 384, 384, 3, (1, 1), ((1, 1), (1, 1))),
    ("s8_co200_ragged_col_tile", torch.int8, 1, 8, 12, 64, 200, 1, (1, 1), ((1, 1), (1, 1))),
    ("s8_stride2_odd_w", torch.int8, 1, 15, 23, 96, 96, 1, (2, 2), ((0, 1), (0, 1))),
    ("s8_persistent", torch.int8, 4, 64, 416, 96, 96, 3, (1, 1), ((1, 1), (1, 1))),
    ("bf16_kt3_bias", torch.bfloat16, 4, 12, 20, 48, 64, 3, (1, 1), ((1, 1), (1, 1))),
    ("bf16_co3_bias", torch.bfloat16, 3, 10, 14, 16, 3, 3, (1, 1), ((1, 1), (1, 1))),
]


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def within_bf16_ulps(got: torch.Tensor, want: torch.Tensor, ulps: int = 1) -> bool:
    """|got - want| <= ulps * ulp(want) elementwise, ulp of bf16's 8-bit significand."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), exp - 8).clamp_min(2.0 ** -126)
    return bool(((got - want).abs() <= ulps * ulp).all())


def mm_inputs(dev, m, k, n, bias_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    w_q = hm.k_major(torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
                     ).to(dev)
    w_scale = torch.from_numpy(rng.uniform(1e-3, 2e-3, size=n).astype(np.float32)).to(dev)
    a_scale = torch.tensor([3.0 / 127.0], device=dev)
    bias = None if bias_dtype is None else torch.from_numpy(
        rng.normal(size=n).astype(np.float32)).to(dev, bias_dtype)
    return x, w_q, w_scale, a_scale, bias


def conv_inputs(dev, dtype, t, h, w, c, co, kt, seed=0):
    """x [T, H, W, C] with its pixels padded to 32 bytes (`pad_channels`), w
    the K-major view (`k_major`), and a bias for bf16."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, size=(t, h, w, c)).astype(np.int8))
        wt = torch.from_numpy(rng.integers(-127, 128, size=(kt, 3, 3, c, co)).astype(np.int8))
        return hc.pad_channels(x.to(dev)), hc.k_major(wt.to(dev)), None
    x = torch.from_numpy(rng.normal(size=(t, h, w, c)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(size=(kt, 3, 3, c, co)) / np.sqrt(kt * 9 * c))
                          .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=co).astype(np.float32))
    return (hc.pad_channels(x.to(dev, dtype)), hc.k_major(wt.to(dev, dtype)),
            b.to(dev, dtype))


def dequant_inputs(dev, co, dynamic_x=None, seed=1):
    rng = np.random.default_rng(seed)
    a_scale = hm.dynamic_scale(dynamic_x) if dynamic_x is not None \
        else torch.tensor(2.5 / 127.0, device=dev)
    scale = torch.from_numpy(rng.uniform(1e-3, 3e-3, size=co).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=co).astype(np.float32)).to(dev, torch.bfloat16)
    return a_scale, scale, b


@pytest.mark.cuda
@pytest.mark.parametrize("name, m, k, n, bias_dtype, dynamic", MM_CASES)
def test_int8_linear_matches_plain_on_gpu(name, m, k, n, bias_dtype, dynamic):
    dev = _device_or_skip()
    x, w_q, w_scale, a_scale, bias = mm_inputs(dev, m, k, n, bias_dtype)
    if dynamic:
        a_scale = hm.dynamic_scale(x)
    got = hm.int8_linear(x, w_q, w_scale, a_scale, bias)
    want = hm.int8_linear_plain(x, w_q, w_scale, a_scale, bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (m, n) and got.dtype == torch.bfloat16
    assert within_bf16_ulps(got, want), (name, (got.float() - want.float()).abs().max().item())


@pytest.mark.cuda
def test_int8_linear_refuses_n_contiguous_weight_on_gpu():
    dev = _device_or_skip()
    x, w_q, w_scale, a_scale, bias = mm_inputs(dev, 300, 256, 192, torch.bfloat16)
    with pytest.raises(ValueError, match="strides"):
        hm.int8_linear(x, w_q.contiguous(), w_scale, a_scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [hm.FAULT_DROP_LAST_K_TILE, hm.FAULT_W_SCALE_SHIFT,
                                   hm.FAULT_STALE_RING_STAGE])
def test_int8_linear_check_catches_planted_fault_on_gpu(fault):
    dev = _device_or_skip()
    x, w_q, w_scale, a_scale, bias = mm_inputs(dev, 300, 1024, 192, torch.bfloat16)
    want = hm.int8_linear_plain(x, w_q, w_scale, a_scale, bias)
    assert within_bf16_ulps(hm._launch(x, w_q, w_scale, a_scale, bias), want)
    assert not within_bf16_ulps(hm._launch(x, w_q, w_scale, a_scale, bias, fault=fault), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype, t, h, w, c, co, kt, stride, padding", CONV_CASES)
def test_conv3x3_matches_plain_on_gpu(name, dtype, t, h, w, c, co, kt, stride, padding):
    dev = _device_or_skip()
    x, wt, b = conv_inputs(dev, dtype, t, h, w, c, co, kt)
    got = hc.conv3x3(x, wt, stride, padding, bias=b)
    want = hc.conv3x3_plain(x, wt, stride, padding, bias=b)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.int8:
        assert torch.equal(got, want), (name, (got - want).abs().max().item())
    else:
        res = hk.agreement(got, want)
        assert res["within_tol"], (name, res)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("fault", [hc.FAULT_ZERO_HALO_ROW, hc.FAULT_DROP_LAST_C32,
                                   hc.FAULT_STALE_RING_STAGE, hc.FAULT_TAP_ROWS])
def test_conv3x3_check_catches_planted_fault_on_gpu(dtype, fault):
    dev = _device_or_skip()
    x, wt, b = conv_inputs(dev, dtype, 4, 12, 20, 64, 96, 3)
    pad = ((1, 1), (1, 1))
    want = hc.conv3x3_plain(x, wt, (1, 1), pad, bias=b)
    got = hc._launch(x, wt, (1, 1), pad, b, fault=fault)
    if dtype == torch.int8:
        assert torch.equal(hc._launch(x, wt, (1, 1), pad), want)
        assert not torch.equal(got, want)
    else:
        assert hk.agreement(hc._launch(x, wt, (1, 1), pad, b), want)["within_tol"]
        assert not hk.agreement(got, want)["within_tol"]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16, 96])
@pytest.mark.parametrize("dynamic", [False, True])
def test_conv_quantize_matches_plain_on_gpu(c, dynamic):
    dev = _device_or_skip()
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.normal(size=(2, 9, 70, c)).astype(np.float32) * 2).to(
        dev, torch.bfloat16)
    a_scale, _, _ = dequant_inputs(dev, 4, x if dynamic else None)
    got = hc.quantize(x, a_scale)
    hc.check_input_layout(got)
    assert torch.equal(got, hc.quantize_plain(x, a_scale))
    store = got.as_strided(got.shape[:-1] + (got.stride(2),), got.stride())
    assert not store[..., c:].any()  # the pad channels are zeros


@pytest.mark.cuda
@pytest.mark.parametrize("name, dtype, t, h, w, c, co, kt, stride, padding",
                         [case for case in CONV_CASES if case[1] == torch.int8])
def test_conv3x3_dequant_is_the_torch_dequantise_on_gpu(name, dtype, t, h, w, c, co, kt, stride,
                                                       padding):
    """The fused epilogue against the torch dequantise of the plain int32
    sums, bit for bit; and int8_conv (pre-pass + fused conv) against the
    plain int8 conv, bit for bit, static and dynamic scale."""
    dev = _device_or_skip()
    xq, wt, _ = conv_inputs(dev, dtype, t, h, w, c, co, kt)
    a_scale, scale, b = dequant_inputs(dev, co)
    got = hc.conv3x3_dequant(xq, wt, a_scale, scale, b, stride, padding)
    want = hc.dequantize_plain(hc.conv3x3_plain(xq, wt, stride, padding), a_scale, scale, b,
                               torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16)), name
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(t, h, w, c)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    for a in (a_scale, hm.dynamic_scale(x)):
        got = hc.int8_conv(x, wt, a, scale, b, stride, padding)
        want = hc.int8_conv_plain(x, wt, a, scale, b, stride, padding)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), name


@pytest.mark.cuda
def test_conv3x3_refuses_other_layouts_on_gpu():
    dev = _device_or_skip()
    x, wt, _ = conv_inputs(dev, torch.int8, 3, 8, 12, 64, 96, 3)
    with pytest.raises(ValueError, match="k_major"):
        hc.conv3x3(x, wt.contiguous())  # Co contiguous: the JAX layout as stored
    with pytest.raises(ValueError, match="pad_channels"):
        hc.conv3x3(torch.zeros((1, 8, 12, 3), dtype=torch.int8, device=dev),
                   hc.k_major(torch.zeros((1, 3, 3, 3, 8), dtype=torch.int8, device=dev)))
