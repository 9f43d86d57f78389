"""The port's int8 conv (K4/K5's module, `ops/hopper_conv.py`, through
`models/vae.py`) against the JAX package's int8 VAE convs on the CPU: the s8
product itself (JAX: the tap-merged `lax.conv` with an int32 result; the
port: the kt x 3 x 3 conv with the taps inside), then `_int8_conv2d`,
`conv2d` (stride 1 and the encoder's stride-2 downsample), `conv3d` with kt
= 3 and the T=1 tap-skip of `causal_conv3d`, static and dynamic scales.

The quanta and the int32 sums must be equal element for element; the
dequantised outputs may differ only by the f32 epilogue's rounding (rtol
1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.ops import hopper_conv as hc

PAD1 = ((1, 1), (1, 1))
DOWN = ((0, 1), (0, 1))


def params(kt, c, co, static, seed):
    rng = np.random.default_rng(seed)
    p = {"w_q": rng.integers(-127, 128, size=(kt, 3, 3, c, co)).astype(np.int8),
         "scale": rng.uniform(1e-3, 3e-3, size=co).astype(np.float32),
         "b": rng.normal(size=co).astype(np.float32)}
    if static:
        p["a_scale"] = np.float32(3.0 / 127.0)
    return p


def both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def act(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 1.5).astype(np.float32)


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kt, shape, co, stride, padding", [
    (1, (2, 10, 12, 8), 12, (1, 1), PAD1),
    (1, (1, 10, 12, 3), 16, (1, 1), PAD1),   # ragged C = 3
    (1, (1, 10, 12, 8), 8, (2, 2), DOWN),    # stride-2 downsample
    (3, (5, 6, 7, 8), 12, (1, 1), PAD1),     # temporal taps inside
])
def test_s8_product_equals_jax_int32(kt, shape, co, stride, padding):
    rng = np.random.default_rng(kt + shape[-1])
    xq = rng.integers(-127, 128, size=shape).astype(np.int8)
    wq = rng.integers(-127, 128, size=(kt, 3, 3, shape[-1], co)).astype(np.int8)
    t_out = shape[0] - kt + 1
    taps = np.concatenate([xq[i:i + t_out] for i in range(kt)], axis=-1)
    merged = wq.transpose(1, 2, 0, 3, 4).reshape(3, 3, kt * shape[-1], co)
    want = jvae._spatial_conv(jnp.asarray(taps), jnp.asarray(merged), stride, padding,
                              preferred=jnp.int32)
    got = hc.conv3x3(torch.from_numpy(xq), torch.from_numpy(wq), stride, padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("stride, padding", [((1, 1), PAD1), ((2, 2), DOWN)])
def test_int8_conv2d_matches_jax(static, stride, padding):
    p = params(1, 8, 12, static, 1)
    # the JAX function takes w_q [kh, kw, ci, co] (taps merged), the port's the
    # quantised tree's [kt, kh, kw, ci, co]
    jp, _ = both(dict(p, w_q=p["w_q"][0]))
    jp5, tp5 = both(p)
    x = act((2, 10, 12, 8), 2)
    xq_j, a_j = jvae._quantize_act(jp, jnp.asarray(x))
    xq_t, a_t = tvae._quantize_act(tp5, torch.from_numpy(x))
    assert float(a_t) == float(a_j)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    close(tvae._int8_conv2d(tp5, torch.from_numpy(x), stride, padding),
          jvae._int8_conv2d(jp, jnp.asarray(x), stride, padding))
    # conv2d on the quantised tree's [1, kh, kw, ci, co] weights
    close(tvae.conv2d(tp5, torch.from_numpy(x), stride, padding),
          jvae.conv2d(jp5, jnp.asarray(x), stride, padding))


@pytest.mark.parametrize("static", [True, False])
def test_int8_conv3d_taps_match_jax(static):
    jp, tp = both(params(3, 8, 12, static, 3))
    x = act((5, 6, 7, 8), 4)
    close(tvae.conv3d(tp, torch.from_numpy(x), padding=PAD1),
          jvae.conv3d(jp, jnp.asarray(x), padding=PAD1))


@pytest.mark.parametrize("static", [True, False])
def test_int8_t1_tapskip_matches_jax(static):
    """A fresh single frame through causal_conv3d: only the last tap runs, and
    the new cache holds a zero frame and the input."""
    jp, tp = both(params(3, 8, 12, static, 5))
    x = act((1, 6, 7, 8), 6)
    jio, tio = jvae._CacheIO(None), tvae._CacheIO(None)
    want = jvae.causal_conv3d(jp, jnp.asarray(x), None, jio)
    got = tvae.causal_conv3d(tp, torch.from_numpy(x), None, tio)
    close(got, want)
    close(tio.out[0], jio.out[0])
