"""The port's int8 linear (K3's module, `ops/hopper_int8_mm.py`, through
`models/wan_dit.py::linear`) against the JAX package's `wan_dit.linear` on
int8 weights, on the CPU: static scale, dynamic scale, no bias, and K > 2048
(K3b's K-tiled form). Same numpy inputs on both sides.

Both sides divide x by a_scale in f32 and round half to even, so the quanta
must be equal; the s32 sums are exact on both sides, so the outputs may
differ only by the f32 epilogue's rounding: equal within rtol 1e-6 in f32,
and within one bf16 ulp (rtol 2^-7) in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm

CASES = [  # (name, M, K, N, static, bias)
    ("static", 64, 96, 48, True, True),
    ("dynamic", 64, 96, 48, False, True),
    ("no_bias", 40, 64, 32, True, False),
    ("k_over_2048", 24, 2304, 16, True, True),
]


def make(m, k, n, static, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(1, m, k)) * 2.0).astype(np.float32)
    # a few values on exact quantisation halves: 0.5 * a_scale multiples
    a = np.float32(4.0 / 127.0)
    x[0, 0, :8] = (np.arange(8, dtype=np.float32) + 0.5) * a
    p = {"w_q": rng.integers(-127, 128, size=(k, n)).astype(np.int8),
         "scale": rng.uniform(1e-3, 3e-3, size=n).astype(np.float32)}
    if static:
        p["a_scale"] = a
    if bias:
        p["b"] = rng.normal(size=n).astype(np.float32)
    return x, p


def torch_params(p, dtype):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    if "b" in out:
        out["b"] = out["b"].to(dtype)
    if "a_scale" in out:
        out["a_scale"] = out["a_scale"].reshape(())
    return out


@pytest.mark.parametrize("name, m, k, n, static, bias", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(name, m, k, n, static, bias, dtype):
    x, p = make(m, k, n, static, bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    if "b" in jp:
        jp["b"] = jp["b"].astype(jdt)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tp = torch_params(p, tdt)

    # the quanta
    a_j = jp["a_scale"] if static else \
        jnp.maximum(jnp.max(jnp.abs(jx.astype(jnp.float32))), 1e-6) / 127.0
    xq_j = jnp.clip(jnp.round(jx.astype(jnp.float32) / a_j), -127, 127).astype(jnp.int8)
    a_t = tp["a_scale"] if static else hm.dynamic_scale(tx).reshape(())
    assert float(a_t) == float(a_j)
    np.testing.assert_array_equal(hm.quantize(tx, a_t).numpy(), np.asarray(xq_j))

    want = np.asarray(jdit.linear(jp, jx).astype(jnp.float32))
    got = tdit.linear(tp, tx)
    assert got.dtype == tdt and got.shape == (1, m, n)
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-6)


def test_plain_version_counts_only_cuda_calls():
    """On the CPU the wrapper takes the plain version and counts neither a
    launch nor a plain call on a CUDA tensor."""
    x, p = make(8, 16, 8, True, True)
    hm.reset_launch_counts()
    tdit.linear(torch_params(p, torch.float32), torch.from_numpy(x))
    assert hm.LAUNCHES == {"int8_linear": 0, "int8_linear_k_tiled": 0}
    assert hm.PLAIN_ON_CUDA == {"int8_linear": 0}
