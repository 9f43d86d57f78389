"""SiD and CausVid of the port against (jitted) `jax.value_and_grad` of
the JAX package's, in value and in every gradient leaf at relative
Frobenius 1e-3, on the tiny models, inputs and replayed draws of
tests/test_torch_training.py."""
import jax
import jax.numpy as jnp

from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.training import distillation as jdist
from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.training import distillation as tdist
from test_torch_training import (  # noqa: F401
    REL,
    ReplayDraws,
    _check_grads,
    _noise,
    _trainable,
    jax_loss_and_grads,
    nets,
    rel_fro,
    t_,
)


def test_sid_loss_and_grads(nets):
    jnets, tnets, jcross, tcross = nets
    config = dict(denoising_step_list=[1000, 500], num_frame_per_block=3, sid_alpha=1.0)
    jsid = jdist.SiD(*jnets, jconfig(**config))
    noise = _noise(8)
    jloss, jgrads, record = jax_loss_and_grads(
        lambda p, fp, n, c, cu, k: jsid.generator_loss(p, fp, n, c, cu, k), jnets[0].params,
        jnets[2].params, noise, *jcross, jax.random.PRNGKey(9))
    tsid = tdist.SiD(*tnets, load_server_config(**config))
    gen_params = _trainable(tnets[0])
    draws = ReplayDraws(record)
    loss, _ = tsid.generator_loss(gen_params, tnets[2].params, t_(noise), *tcross, draws)
    loss.backward()
    assert not draws.items
    assert rel_fro(loss.item(), jloss) < REL
    _check_grads(gen_params, jgrads)


def test_causvid_loss_and_grads(nets):
    jnets, tnets, jcross, tcross = nets
    config = dict(denoising_step_list=[1000, 500], num_frame_per_block=3)
    jcv = jdist.CausVid(*jnets, jconfig(**config))
    clean = _noise(10)
    noise = jnp.zeros_like(clean)
    jloss, jgrads, record = jax_loss_and_grads(
        lambda p, fp, n, c, cu, k, x: jcv.generator_loss(p, fp, n, c, cu, k, clean_latent=x),
        jnets[0].params, jnets[2].params, noise, *jcross, jax.random.PRNGKey(11), clean)
    tcv = tdist.CausVid(*tnets, load_server_config(**config))
    gen_params = _trainable(tnets[0])
    draws = ReplayDraws(record)
    loss, _ = tcv.generator_loss(gen_params, tnets[2].params, t_(noise), *tcross, draws,
                                 clean_latent=t_(clean))
    loss.backward()
    assert not draws.items
    assert rel_fro(loss.item(), jloss) < REL
    _check_grads(gen_params, jgrads)
