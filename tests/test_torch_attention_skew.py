"""The skewed window kernels (K6a `_skew_kernel`, K6b `_staticmax_skew_kernel`)
and the attention switches, the port against the JAX package on the CPU.

The JAX side runs `pallas_attention.decode_attention` with `SKEW` or `SKEW2`
set, in TPU interpret mode as tests/test_pallas_attention.py does; the port's
dispatcher takes the same switches to the same route, whose plain version
(the masked softmax every bf16 window route is held to) runs on the CPU.
Tolerance: rtol 2e-3, atol 2e-3 (the Pallas tests' bar).

The dispatcher test replaces the JAX package's four kernel calls with
recorders and holds the port's route to the branch `decode_attention` takes,
for every combination of the switches; `segment_rows` is held to the bk of
`_tiles_for`.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_video_tpu.ops import pallas_attention as pat
from realtime_video_tpu_torch.ops import attention as tattn
from realtime_video_tpu_torch.ops import hopper_attention as hk

TOL = dict(rtol=2e-3, atol=2e-3)
SWITCHES = ("INT8_QK", "SKEW", "SKEW2", "STATIC_MAX")


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def set_switches(monkeypatch, **values):
    for name in SWITCHES:
        monkeypatch.setattr(pat, name, values.get(name, False))
        monkeypatch.setattr(hk, name, values.get(name, False))


# the cases of test_pallas_attention.py's skew tests, and a large-norm input
# whose logit bound sends K6b to its running-max fallback
@pytest.mark.parametrize("switch,route", [("SKEW", "window_skew"),
                                          ("SKEW2", "window_skew_staticmax")])
@pytest.mark.parametrize("lo,hi,scale", [(0, 700, 1.0), (100, 512, 1.0), (0, 1024, 1.0),
                                         (64, 1000, 4.0)])
def test_skew_matches_jax(monkeypatch, switch, route, lo, hi, scale):
    set_switches(monkeypatch, STATIC_MAX=True, **{switch: True})
    b, lq, lk, n, d = 1, 200, 1024, 2, 128
    q, k, v = rand(0, (b, lq, n, d), scale), rand(1, (b, lk, n, d), scale), rand(2, (b, lk, n, d))
    with pltpu.force_tpu_interpret_mode():
        want = pat.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32))
    assert hk.window_route() == route
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)), lo, hi).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if scale > 1:  # the large-norm input really is past the static-max limit
        m = float(hk.logit_bound(hk.prescale(torch.from_numpy(q), d ** -0.5),
                                 torch.from_numpy(k))[0])
        assert m >= hk.STATIC_MAX_LIMIT


def jax_window_branch(monkeypatch):
    """Run pat.decode_attention with recorders in place of its kernel calls;
    return the branch it took as the port names it: (route, static max)."""
    calls = []

    def recorder(name):
        def call(qp, *args, **kwargs):
            calls.append((name, pat.INT8_QK))
            return jnp.zeros_like(qp)
        return call

    for fn in ("_staticmax_skew_call", "_skew_call", "_staticmax_call", "_flash_call"):
        monkeypatch.setattr(pat, fn, recorder(fn))
    q, k = jnp.asarray(rand(3, (1, 8, 1, 128))), jnp.asarray(rand(4, (1, 16, 1, 128)))
    pat.decode_attention(q, k, k, jnp.asarray(2, jnp.int32), jnp.asarray(14, jnp.int32))
    names = {name for name, _ in calls}  # lax.cond traces both of its branches
    if "_staticmax_skew_call" in names:
        return "window_skew_staticmax", True
    if "_skew_call" in names:
        return "window_skew", False
    if "_staticmax_call" in names:
        return "window", True
    assert names == {"_flash_call"}, calls
    return ("window_int8qk" if calls[0][1] else "window"), False


@pytest.mark.parametrize("values", list(itertools.product((False, True), repeat=4)),
                         ids=lambda v: "-".join(n for n, on in zip(SWITCHES, v) if on) or "none")
def test_route_follows_jax_precedence(monkeypatch, values):
    set_switches(monkeypatch, **dict(zip(SWITCHES, values)))
    route = hk.window_route()
    assert (route, hk.static_max(route)) == jax_window_branch(monkeypatch)
    assert hk.block_causal_route() == ("block_causal_int8qk" if hk.INT8_QK else "block_causal")


@pytest.mark.parametrize("bk", [1024, 256])
def test_tiles_for_matches_jax(monkeypatch, bk):
    monkeypatch.setattr(pat, "BK", bk)
    monkeypatch.setattr(hk, "BK", bk)
    for lq, lk in [(200, 1024), (4680, 9360), (4680, 512), (130, 2304), (384, 384),
                   (1, 100), (4680, 4680), (312, 936), (9360, 32760)]:
        assert hk.segment_rows(lk) == pat._tiles_for(lq, lk)[2], (lq, lk)


def test_plain_routes_count_no_launches_on_cpu(monkeypatch):
    """On CPU tensors every route runs its plain version and counts nothing."""
    hk.reset_launch_counts()
    q = torch.from_numpy(rand(5, (1, 8, 2, 128)))
    for switch in ("INT8_QK", "SKEW", "SKEW2"):
        set_switches(monkeypatch, **{switch: True})
        tattn.decode_attention(q, q, q, 0, 8)
        tattn.block_causal_attention(q, q, q, 4)
    assert not any(hk.LAUNCHES.values()) and not any(hk.PLAIN_ON_CUDA.values())
