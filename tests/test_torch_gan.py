"""GAN distillation of the port against the JAX package's, on the CPU in f32
at tiny dims (tests/test_torch_training.py's networks, inputs and replayed
draws; the losses on one 3-frame block): the discriminator's logits (`gan_block_apply`, `dit_classify`, taps
(0, 1), 4 classes, with and without the time embedding) at relative
Frobenius 1e-4; the generator loss in value and in every gradient leaf
against jitted `jax.value_and_grad` at REL = 1e-3; the head's tree through
`gan_params_from_jax` bit for bit; and the per-layer checkpointing that
`dit_forward` applies, whose gradients must equal the dense path's (1e-6).
The critic loss, with these helpers: test_torch_gan_critic.py (standard,
R1 + R2, and without a real latent) and
test_torch_gan_critic_relativistic.py.

The JAX critic draws its R1 / R2 perturbations and the perturbed logits'
noise from the keys of the real / fake logits' noise: those recorded draws
repeat earlier ones bit for bit (asserted), and the port reuses the earlier
draws, so the replay drops the repeats (`_drop_repeats`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.models import wan_dit as jwan_dit
from realtime_video_tpu.training import gan as jgan
from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.models import wan_dit as twan_dit
from realtime_video_tpu_torch.training import gan as tgan
from realtime_video_tpu_torch.training import losses as tlosses
from realtime_video_tpu_torch.utils.convert import gan_params_from_jax
from test_torch_training import (  # noqa: F401
    DMD_CONFIG,
    REL,
    F,
    ReplayDraws,
    _check_grads,
    _noise,
    _trainable,
    jax_draws,
    nets,
    rel_fro,
    t_,
)

GAN_CONFIG = dict(DMD_CONFIG, gan_taps=[0, 1], num_class=1, gan_g_weight=0.5,
                  gan_d_weight=0.5)
#: the losses' latents: one block of 3 frames (the multi-block rollout is
#: held by the DMD tests; one block keeps XLA's compile of the JAX side short)
LOSS_SHAPE = (1, 3, 16, 4, 4)


def _head(cfg, num_class=1, concat_time=False, key=0):
    """A JAX head with nonzero biases and norms (the init's zeros and ones
    would leave those gradients untested), and the port's copy."""
    gp = jgan.init_gan_head_params(jax.random.PRNGKey(key), cfg, num_class=num_class,
                                   num_registers=2, concat_time=concat_time)
    leaves, tree = jax.tree_util.tree_flatten(gp)
    rng = np.random.default_rng(key)
    leaves = [jnp.asarray(np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32))
              for a in leaves]
    gp = jax.tree_util.tree_unflatten(tree, leaves)
    return gp, gan_params_from_jax(jax.device_get(gp))


def test_gan_params_from_jax_round_trip(nets):
    jnets = nets[0]
    gp = jgan.init_gan_head_params(jax.random.PRNGKey(3), jnets[2].cfg, num_class=2,
                                   num_registers=3, concat_time=True)
    tp = gan_params_from_jax(jax.device_get(gp))
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(a)
             for path, a in jax.tree_util.tree_flatten_with_path(gp)[0]}
    tflat = tlosses.tree_leaves(tp)
    assert set(jflat) == set(tflat) and len(tp["blocks"]) == 3
    for name, a in jflat.items():
        assert tflat[name].dtype == torch.float32
        np.testing.assert_array_equal(tflat[name].numpy(), a, err_msg=name)
    # the port's own init: the JAX structure and shapes
    own = tgan.init_gan_head_params(torch.Generator().manual_seed(0), nets[1][2].cfg,
                                    num_class=2, num_registers=3, concat_time=True)
    assert {k: tuple(v.shape) for k, v in tlosses.tree_leaves(own).items()} == \
        {k: a.shape for k, a in jflat.items()}


@pytest.mark.parametrize("concat_time", [False, True])
def test_classify_logits_match(nets, concat_time):
    jnets, tnets, jcross, tcross = nets
    jfake, tfake = jnets[2], tnets[2]
    gp, tp = _head(jfake.cfg, num_class=4, concat_time=concat_time)
    noisy = _noise(8)
    t = jnp.asarray(np.array([[900.0] * 3 + [300.0] * 3], np.float32))
    jl = jwan_dit.dit_classify(jfake.cfg, jfake.params, noisy, t, jfake.rope, jcross[0], gp,
                               taps=(0, 1), concat_time=concat_time)
    with torch.no_grad():
        tl = twan_dit.dit_classify(tfake.cfg, tfake.params, t_(noisy), t_(t), tfake.rope,
                                   tcross[0], tp, taps=(0, 1), concat_time=concat_time)
    assert tuple(tl.shape) == (1, 4)
    assert rel_fro(tl.numpy(), jl) < 1e-4
    # one GanAttentionBlock alone
    x = _noise(9, (1, 24, jfake.cfg.dim))
    reg = _noise(10, (1, 1, jfake.cfg.dim))
    jy = jwan_dit.gan_block_apply(jfake.cfg, gp["blocks"][1], x, reg)
    with torch.no_grad():
        ty = twan_dit.gan_block_apply(tfake.cfg, tp["blocks"][1], t_(x), t_(reg))
    assert tuple(ty.shape) == (1, 1, jfake.cfg.dim) and rel_fro(ty.numpy(), jy) < 1e-4


def _draws_without_classify(fn, *args, num_class=1):
    """`jax_draws` with the classify forward stubbed out too."""
    saved = jwan_dit.dit_classify
    jwan_dit.dit_classify = lambda cfg, params, noisy, *a, **k: jnp.zeros(
        (noisy.shape[0], num_class), noisy.dtype)
    try:
        return jax_draws(fn, *args)
    finally:
        jwan_dit.dit_classify = saved


def _drop_repeats(record):
    """(the record without the normal draws that repeat an earlier one bit
    for bit, how many were dropped)."""
    kept, dropped = [], 0
    for kind, a in record:
        if kind == "normal" and any(k == "normal" and b.shape == a.shape and np.array_equal(b, a)
                                    for k, b in kept):
            dropped += 1
            continue
        kept.append((kind, a))
    return kept, dropped


def _nets_and_heads(nets, config):
    jnets, tnets, _, _ = nets
    gp, tp = _head(jnets[2].cfg)
    jm = jgan.GAN(*jnets, jconfig(**config), gan_params=gp)
    tm = tgan.GAN(*tnets, load_server_config(**config), gan_params=tp)
    assert tm.taps == jm.taps == (0, 1)
    return jm, tm


@pytest.fixture(scope="module")
def generator_case(nets):
    jnets, _, jcross, _ = nets
    jm, _ = _nets_and_heads(nets, GAN_CONFIG)
    noise = _noise(5, LOSS_SHAPE)
    fn = lambda p, fp, n, c, cu, k: jm.generator_loss(p, fp, n, c, cu, k)  # noqa: E731
    args = (jnets[0].params, jnets[2].params, noise, *jcross, jax.random.PRNGKey(6))
    record = _draws_without_classify(fn, *args)
    (loss, aux), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(*args)
    return noise, float(loss), float(aux["gan_g_loss"]), grads, record


def _generator(nets, noise, record):
    _, tnets, _, tcross = nets
    _, tm = _nets_and_heads(nets, GAN_CONFIG)
    gen_params, fake_params = _trainable(tnets[0]), _trainable(tnets[2])
    tlosses.trainable(tm.gan_params)
    draws = ReplayDraws(record)
    loss, aux = tm.generator_loss(gen_params, fake_params, t_(noise), *tcross, draws)
    loss.backward()
    assert not draws.items
    return loss, aux, gen_params, fake_params, tm.gan_params


def test_generator_loss_and_grads(nets, generator_case):
    noise, jloss, jg_adv, jgrads, record = generator_case
    loss, aux, gen_params, fake_params, head = _generator(nets, noise, record)
    assert rel_fro(loss.item(), jloss) < REL
    assert rel_fro(aux["gan_g_loss"].item(), jg_adv) < REL
    _check_grads(gen_params, jgrads)
    # the gradient reaches the generator only, through its x0
    assert all(t.grad is None for t in tlosses.tree_leaves(fake_params).values())
    assert all(t.grad is None for t in tlosses.tree_leaves(head).values())


def check_critic(nets, overrides, with_real: bool):
    """The port's critic loss (its value, DMD's part and every gradient leaf
    of the (fake score, head) pair) against jitted `jax.value_and_grad` of
    the JAX package's, under GAN_CONFIG with `overrides`."""
    jnets, tnets, jcross, tcross = nets
    jm, tm = _nets_and_heads(nets, dict(GAN_CONFIG, **overrides))
    noise = _noise(5, LOSS_SHAPE)
    real = _noise(11, LOSS_SHAPE) if with_real else None

    def fn(fg, gp, n, c, k, r):
        return jm.critic_loss(fg, gp, n, c, k, real_latent=r)

    args = ((jnets[2].params, jm.gan_params), jnets[0].params, noise, jcross[0],
            jax.random.PRNGKey(7), real)
    record, dropped = _drop_repeats(_draws_without_classify(fn, *args))
    # R1 and R2 each repeat two draws: the perturbation and the logits' noise
    penalties = sum(overrides.get(w, 0) > 0 for w in ("r1_weight", "r2_weight"))
    assert dropped == (2 * penalties if with_real else 0)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(*args)

    fake_params = _trainable(tnets[2])
    head = tlosses.trainable(tm.gan_params)
    gen_params = _trainable(tnets[0])
    draws = ReplayDraws(record)
    loss, aux = tm.critic_loss((fake_params, head), gen_params, t_(noise), tcross[0], draws,
                               real_latent=None if real is None else t_(real))
    loss.backward()
    assert not draws.items
    assert rel_fro(loss.item(), jloss) < REL
    assert rel_fro(aux["critic_loss"].item(), jaux["critic_loss"]) < REL
    assert ("gan_d_loss" in aux) == with_real
    if with_real:
        assert rel_fro(aux["gan_d_loss"].item(), jaux["gan_d_loss"]) < REL
    _check_grads((fake_params, head), jgrads)
    assert all(t.grad is None for t in tlosses.tree_leaves(gen_params).values())
    assert sum(float(t.grad.abs().sum()) for t in tlosses.tree_leaves(head).values()
               if t.grad is not None) > 0


def test_layer_checkpointing_gives_the_dense_gradients(nets, generator_case, monkeypatch):
    """The GAN generator loss with every layer checkpointed (the taps read
    each checkpointed layer's output) and with the checkpoint replaced by a
    plain call: the same loss and gradient leaves (1e-6)."""
    noise, _, _, _, record = generator_case
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    loss, _, params, _, _ = _generator(nets, noise, record)
    ckpt = {k: t.grad.clone() for k, t in tlosses.tree_leaves(params).items()
            if t.grad is not None}
    assert calls and ckpt
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))
    dense_loss, _, dense_params, _, _ = _generator(nets, noise, record)
    dense = {k: t.grad for k, t in tlosses.tree_leaves(dense_params).items()
             if t.grad is not None}
    assert rel_fro(loss.item(), dense_loss.item()) < 1e-6 and ckpt.keys() == dense.keys()
    for k in ckpt:
        assert rel_fro(ckpt[k].numpy(), dense[k].numpy()) < 1e-6, k
