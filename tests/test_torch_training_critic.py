"""DMD's critic loss, the ODE regression loss and the causal flow-matching
loss of the port against (jitted) `jax.value_and_grad` of the JAX
package's, in value and in every gradient leaf at relative Frobenius 1e-3,
on the tiny models, inputs and replayed draws of
tests/test_torch_training.py."""
import jax
import jax.numpy as jnp
import pytest

from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.training import distillation as jdist
from realtime_video_tpu.training import losses as jlosses
from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.training import distillation as tdist
from realtime_video_tpu_torch.training import losses as tlosses
from test_torch_training import (  # noqa: F401
    DMD_CONFIG,
    REL,
    F,
    ReplayDraws,
    _check_grads,
    _noise,
    _trainable,
    jax_loss_and_grads,
    nets,
    rel_fro,
    t_,
)


def test_dmd_critic_loss_and_grads(nets):
    jnets, tnets, jcross, tcross = nets
    jdmd = jdist.DMD(*jnets, jconfig(**DMD_CONFIG))
    noise = _noise(5)
    jloss, jgrads, record = jax_loss_and_grads(
        lambda p, gp, n, c, k: jdmd.critic_loss(p, gp, n, c, k), jnets[2].params,
        jnets[0].params, noise, jcross[0], jax.random.PRNGKey(7))
    tdmd = tdist.DMD(*tnets, load_server_config(**DMD_CONFIG))
    gen_params, fake_params = _trainable(tnets[0]), _trainable(tnets[2])
    draws = ReplayDraws(record)
    loss, _ = tdmd.critic_loss(fake_params, gen_params, t_(noise), tcross[0], draws)
    loss.backward()
    assert not draws.items
    assert rel_fro(loss.item(), jloss) < REL
    _check_grads(fake_params, jgrads)
    assert all(t.grad is None for t in tlosses.tree_leaves(gen_params).values())


def test_ode_regression_loss_and_grads(nets):
    jnets, tnets, jcross, tcross = nets
    noisy, target = _noise(12), _noise(13)
    t = jnp.full((1, F), 500.0, jnp.float32)
    jloss, jgrads, _ = jax_loss_and_grads(
        lambda p, x, y, tt, c: jdist.ode_regression_loss(jnets[0], p, x, y, tt, c),
        jnets[0].params, noisy, target, t, jcross[0], has_aux=False)
    gen_params = _trainable(tnets[0])
    loss = tdist.ode_regression_loss(tnets[0], gen_params, t_(noisy), t_(target), t_(t),
                                     tcross[0])
    loss.backward()
    assert rel_fro(loss.item(), jloss) < REL
    _check_grads(gen_params, jgrads)


def test_causal_flow_matching_loss_and_grads(nets):
    """The cross K/V are computed inside this loss: their projections and
    the text embedding get gradients on both sides."""
    jnets, tnets, _, _ = nets
    latents = _noise(14)
    emb = _noise(15, (1, 16, jnets[0].cfg.text_dim))
    record = []
    jloss, jgrads, record = jax_loss_and_grads(
        lambda p, x, e, k: jlosses.causal_flow_matching_loss(jnets[0], p, x, e, k),
        jnets[0].params, latents, emb, jax.random.PRNGKey(16))
    _, jaux = jlosses.causal_flow_matching_loss(jnets[0], jnets[0].params, latents, emb,
                                                jax.random.PRNGKey(16))
    gen_params = _trainable(tnets[0])
    draws = ReplayDraws(record)
    loss, aux = tlosses.causal_flow_matching_loss(tnets[0], gen_params, t_(latents), t_(emb),
                                                  draws)
    loss.backward()
    assert not draws.items
    assert rel_fro(loss.item(), jloss) < REL
    assert aux["mean_timestep"].item() == pytest.approx(float(jaux["mean_timestep"]))
    _check_grads(gen_params, jgrads)
    assert tlosses.tree_leaves(gen_params)["blocks/cross_attn/k/w"].grad.abs().sum() > 0
