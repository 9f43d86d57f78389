"""The port's flow-matching solvers against the JAX package's, step for step,
on the CPU in f32: the same numpy sample goes through both with a fixed
affine flow (flow = a * sample + c, a and c numpy arrays from a seed), for
UniPC and DPM++ at orders 1-3, DPM++ with and without the explicit
`get_sampling_sigmas` ladder, 3, 6 and 20 steps, shifts 3 and 5, and UniPC
with its corrector disabled after one step. `sigmas` and `timesteps` must be
exactly equal; every step's sample within relative Frobenius 1e-6."""
import itertools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu import solvers as jsol
from realtime_video_tpu_torch import solvers as tsol

REL = 1e-6
SHAPE = (1, 3, 4, 6, 6)

CASES = (
    [("unipc", order, steps, shift, False, ())
     for order, steps, shift in itertools.product((1, 2, 3), (3, 6, 20), (3.0, 5.0))]
    + [("dpm++", order, steps, shift, ladder, ())
       for order, steps, shift, ladder in itertools.product((1, 2, 3), (3, 6, 20), (3.0, 5.0),
                                                            (False, True))]
    + [("unipc", 2, 6, 5.0, False, (2,)), ("unipc", 3, 20, 5.0, False, (0,))]
)


def _case_id(case) -> str:
    name, order, steps, shift, ladder, off = case
    return (f"{name}-o{order}-n{steps}-s{shift:g}" + ("-ladder" if ladder else "")
            + (f"-nocorr{off[0]}" if off else ""))


def _make(mod, name, order, steps, shift, ladder, off):
    if name == "unipc":
        solver = mod.FlowUniPCMultistep(shift=shift, solver_order=order, disable_corrector=off)
    else:
        solver = mod.FlowDPMSolverMultistep(shift=shift, solver_order=order)
    sigmas = mod.get_sampling_sigmas(steps, shift) if ladder else None
    solver.set_timesteps(steps, shift=shift, sigmas=sigmas)
    return solver


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_solver_matches_jax_step_for_step(case):
    rng = np.random.default_rng(zlib.crc32(_case_id(case).encode()))
    x = rng.normal(size=SHAPE).astype(np.float32)
    a = (rng.normal(size=SHAPE) * 0.3 - 1.0).astype(np.float32)
    c = rng.normal(size=SHAPE).astype(np.float32)
    js, ts = _make(jsol, *case), _make(tsol, *case)
    assert np.array_equal(ts.sigmas, js.sigmas) and ts.sigmas.dtype == js.sigmas.dtype
    assert np.array_equal(ts.timesteps, js.timesteps)
    assert ts.timesteps.dtype == js.timesteps.dtype == np.float32
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ja, jc, ta, tc = jnp.asarray(a), jnp.asarray(c), torch.from_numpy(a), torch.from_numpy(c)
    for t in js.timesteps:
        jx = js.step(ja * jx + jc, float(t), jx)
        tx = ts.step(ta * tx + tc, float(t), tx)
        assert tx.dtype == torch.float32
        assert rel_fro(tx.numpy(), np.asarray(jx)) < REL
    assert ts.num_steps == js.num_steps == case[2]


def test_updates_keep_a_bf16_sample_bf16():
    """A Python float times a bf16 tensor stays bf16, in torch as in JAX."""
    for name in ("unipc", "dpm++"):
        solver = tsol.make_solver(name, 4, 5.0)
        x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
        for t in solver.timesteps:
            x = solver.step(-x, float(t), x)
            assert x.dtype == torch.bfloat16
        assert torch.isfinite(x.float()).all()
    with pytest.raises(NotImplementedError):
        tsol.make_solver("euler", 4, 5.0)
