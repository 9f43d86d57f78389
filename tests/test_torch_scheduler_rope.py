"""The port's flow-matching schedule and RoPE against the JAX package's, on the
CPU. Tables rtol 1e-5 (the bar tests/test_scheduler.py holds); rotated
values and noise mixes rtol 1e-5, atol 1e-6 (f32 arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.models import rope as jrope
from realtime_video_tpu.scheduler import FlowMatchSchedule as JSched
from realtime_video_tpu.scheduler import get_denoising_schedule as jsched_steps
from realtime_video_tpu_torch.models import rope as trope
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule as TSched
from realtime_video_tpu_torch.scheduler import get_denoising_schedule as tsched_steps

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shift,steps,extra", [(5.0, 1000, True), (3.0, 50, False)])
def test_schedule_tables_match(shift, steps, extra):
    j = JSched.create(num_inference_steps=steps, shift=shift, sigma_min=0.0,
                      extra_one_step=extra)
    t = TSched.create(num_inference_steps=steps, shift=shift, sigma_min=0.0,
                      extra_one_step=extra)
    np.testing.assert_allclose(t.sigmas.numpy(), np.asarray(j.sigmas), rtol=1e-5)
    np.testing.assert_allclose(t.timesteps.numpy(), np.asarray(j.timesteps), rtol=1e-5)
    np.testing.assert_allclose(t.zero_padded_timesteps().numpy(),
                               np.asarray(j.zero_padded_timesteps()), rtol=1e-5)


@pytest.mark.parametrize("strength,steps", [(1.0, 4), (1.0, 5), (0.7, 3)])
def test_denoising_schedule_matches(strength, steps):
    j = JSched.create(shift=5.0, sigma_min=0.0, extra_one_step=True)
    t = TSched.create(shift=5.0, sigma_min=0.0, extra_one_step=True)
    np.testing.assert_allclose(
        tsched_steps(t.zero_padded_timesteps(), strength, steps),
        jsched_steps(np.asarray(j.zero_padded_timesteps()), strength, steps), rtol=1e-5)


def test_add_noise_and_flow_to_x0_match():
    rng = np.random.default_rng(0)
    x0, nz, flow = (rng.normal(size=(1, 3, 4, 6, 6)).astype(np.float32) for _ in range(3))
    ts = np.asarray([[937.5, 833.3, 0.0]], np.float32)
    j = JSched.create(shift=5.0, sigma_min=0.0, extra_one_step=True)
    t = TSched.create(shift=5.0, sigma_min=0.0, extra_one_step=True)
    np.testing.assert_allclose(
        t.add_noise(torch.from_numpy(x0), torch.from_numpy(nz), torch.from_numpy(ts)).numpy(),
        np.asarray(j.add_noise(jnp.asarray(x0), jnp.asarray(nz), jnp.asarray(ts))), **TOL)
    np.testing.assert_allclose(
        t.flow_to_x0(torch.from_numpy(flow), torch.from_numpy(x0), torch.from_numpy(ts)).numpy(),
        np.asarray(j.flow_to_x0(jnp.asarray(flow), jnp.asarray(x0), jnp.asarray(ts))), **TOL)


@pytest.mark.parametrize("head_dim,grid,start", [(128, (3, 4, 5), 0), (32, (2, 3, 3), 7)])
def test_rope_tables_and_apply_match(head_dim, grid, start):
    jt, tt = jrope.RopeTables.create(head_dim), trope.RopeTables.create(head_dim)
    for name in ("cos_t", "sin_t", "cos_h", "sin_h", "cos_w", "sin_w"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                   rtol=1e-5, atol=1e-7)
    jc, js = jt.fused(*grid, start)
    tc, ts = tt.fused(*grid, start)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    L = grid[0] * grid[1] * grid[2]
    x = np.random.default_rng(1).normal(size=(1, L, 2, head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        trope.rope_apply_fused(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jrope.rope_apply_fused(jnp.asarray(x), jc, js)), **TOL)


def test_sinusoidal_embedding_matches():
    """atol 1e-4: at positions near 1000 one f32 ulp of the angle (6.1e-5)
    separates jnp.power from torch.pow."""
    pos = np.asarray([0.0, 1.0, 250.0, 937.5, 999.0], np.float32)
    np.testing.assert_allclose(
        trope.sinusoidal_embedding_1d(256, torch.from_numpy(pos)).numpy(),
        np.asarray(jrope.sinusoidal_embedding_1d(256, jnp.asarray(pos))), rtol=1e-5, atol=1e-4)
