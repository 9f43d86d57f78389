"""DMD's generator loss (the self-forcing rollout, then the distribution
matching loss) against jitted `jax.value_and_grad` of the JAX package's, in
value and in every gradient leaf at relative Frobenius 1e-3, on the tiny
models, inputs and replayed draws of tests/test_torch_training.py; and
the per-layer checkpointing that `dit_forward` applies whenever a layer
keeps a graph gives the dense path's loss and gradients."""
import jax
import pytest
import torch
import torch.utils.checkpoint

from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.training import distillation as jdist
from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.training import distillation as tdist
from realtime_video_tpu_torch.training import losses as tlosses
from test_torch_training import (  # noqa: F401
    DMD_CONFIG,
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


@pytest.fixture(scope="module")
def dmd_generator_jax(nets):
    jnets, _, jcross, _ = nets
    jdmd = jdist.DMD(*jnets, jconfig(**DMD_CONFIG))
    noise = _noise(5)
    loss, grads, draws = jax_loss_and_grads(
        lambda p, fp, n, c, cu, k: jdmd.generator_loss(p, fp, n, c, cu, k), jnets[0].params,
        jnets[2].params, noise, *jcross, jax.random.PRNGKey(6))
    return noise, loss, grads, draws


def _generator_loss(nets, noise, record):
    """(loss, aux, generator params, fake-score params) of the port's DMD
    generator loss on the replayed draws, after its backward."""
    _, tnets, _, tcross = nets
    tdmd = tdist.DMD(*tnets, load_server_config(**DMD_CONFIG))
    gen_params, fake_params = _trainable(tnets[0]), _trainable(tnets[2])
    draws = ReplayDraws(record)
    loss, aux = tdmd.generator_loss(gen_params, fake_params, t_(noise), *tcross, draws)
    loss.backward()
    assert not draws.items
    return loss, aux, gen_params, fake_params


def test_dmd_generator_loss_and_grads(nets, dmd_generator_jax):
    noise, jloss, jgrads, record = dmd_generator_jax
    loss, aux, gen_params, fake_params = _generator_loss(nets, noise, record)
    assert rel_fro(loss.item(), jloss) < REL and aux["dmd_loss"] is loss
    _check_grads(gen_params, jgrads)
    assert all(t.grad is None for t in tlosses.tree_leaves(fake_params).values())


def test_layer_checkpointing_gives_the_dense_gradients(nets, dmd_generator_jax, monkeypatch):
    """The generator loss with every layer checkpointed (as `dit_forward`
    runs it) and with the checkpoint replaced by a plain call: the same loss
    and the same gradient leaves (1e-6), and the checkpointed run really
    checkpoints."""
    noise, _, _, record = dmd_generator_jax
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    loss, _, params, _ = _generator_loss(nets, noise, record)
    ckpt = {k: t.grad.clone() for k, t in tlosses.tree_leaves(params).items()
            if t.grad is not None}
    assert calls and ckpt
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))
    dense_loss, _, dense_params, _ = _generator_loss(nets, noise, record)
    dense = {k: t.grad for k, t in tlosses.tree_leaves(dense_params).items()
             if t.grad is not None}
    assert rel_fro(loss.item(), dense_loss.item()) < 1e-6 and ckpt.keys() == dense.keys()
    for k in ckpt:
        assert rel_fro(ckpt[k].numpy(), dense[k].numpy()) < 1e-6, k
