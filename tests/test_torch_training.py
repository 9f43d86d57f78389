"""The port's self-forcing rollout and DMD losses against (jitted)
`jax.value_and_grad` of the JAX package's, on tests/test_training.py's tiny
models (WAN_TINY, 6 latent frames of 4x4, random heads) in f32 on the CPU:
the same numpy weights and cross-attention K/V on both sides, and JAX's
`jax.random.normal` / `randint` draws recorded in call order
(`jax_draws`) and replayed through the port's `Draws` (`ReplayDraws`), so
both sides see the same exit flags, timesteps and noise.

At relative Frobenius 1e-3, in value and in every gradient leaf (a leaf
whose JAX gradient is zero must get none, or zeros):
  * the self-forcing rollout (values and exit flags; with context noise and
    per-block exit steps too);
A gradient through the serving cache (written in place) is refused; the
rollout decodes into the training cache. The losses are held the same way,
with these helpers: DMD's generator loss in test_torch_training_dmd.py, SiD
and CausVid in test_torch_training_losses.py, DMD's critic loss, the ODE
regression loss and the causal flow-matching loss in
test_torch_training_critic.py.
The JAX side runs its dense XLA attention (its Pallas kernels cannot be
differentiated); the port's goes through `KernelAttention`'s plain CPU path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import WanModelConfig as JCfg
from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.models import wan_dit as jwan_dit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.pipelines.self_forcing_training import (
    SelfForcingTrainingPipeline as JPipe,
)
from realtime_video_tpu.training import distillation as jdist
from realtime_video_tpu.training import losses as jlosses
from realtime_video_tpu_torch.config import WanModelConfig, load_server_config
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.pipelines.self_forcing_training import (
    SelfForcingTrainingPipeline,
)
from realtime_video_tpu_torch.training import distillation as tdist
from realtime_video_tpu_torch.training import losses as tlosses
from realtime_video_tpu_torch.utils.convert import tree_from_numpy, wan_params_from_jax

DIMS = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
H = W = 4
F = 6
REL = 1e-3


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


class ReplayDraws:
    """The port's `Draws`, handing out recorded JAX draws in order."""

    def __init__(self, record):
        self.items = list(record)

    def _next(self, kind, shape):
        got_kind, a = self.items.pop(0)
        assert got_kind == kind and a.shape == tuple(shape), (got_kind, a.shape, kind, shape)
        return a

    def normal(self, shape, dtype, device):
        return torch.from_numpy(np.array(self._next("normal", shape), np.float32)).to(
            device=device, dtype=dtype)

    def randint(self, low, high, shape):
        return torch.from_numpy(np.array(self._next("randint", shape), np.int64))


def jax_draws(fn, *args):
    """The `jax.random.normal` / `randint` results of fn(*args), in call
    order. None of them depends on a network's output, so this pass runs
    with the DiT forwards stubbed out (zeros), eagerly, and the real
    computation can be jitted."""
    record = []
    saved = (jax.random.normal, jax.random.randint, JGen.forward, jwan_dit.dit_forward)

    def rec(kind, draw):
        def wrapped(*a, **k):
            out = draw(*a, **k)
            record.append((kind, np.asarray(out)))
            return out
        return wrapped

    def forward(self, params, noisy, cross, t, kv_cache=None, **k):
        return jnp.zeros_like(noisy), jnp.zeros_like(noisy), kv_cache

    jax.random.normal, jax.random.randint = rec("normal", saved[0]), rec("randint", saved[1])
    JGen.forward = forward
    jwan_dit.dit_forward = lambda cfg, params, x, *a, **k: (jnp.zeros_like(x), None)
    try:
        fn(*args)
    finally:
        jax.random.normal, jax.random.randint, JGen.forward, jwan_dit.dit_forward = saved
    return record


def _random_head(jgen, key):
    """As tests/test_training.py: the zero-init head makes fresh fake and
    real scores identical, so randomise it."""
    w = jgen.params["head"]["head"]["w"]
    jgen.params["head"]["head"]["w"] = (
        jax.random.normal(jax.random.PRNGKey(key), w.shape, jnp.float32) * 0.05)
    return jgen


@pytest.fixture(scope="module")
def nets():
    jcfg = JCfg(**DIMS)
    jnets = [_random_head(JGen(cfg=jcfg, dtype=jnp.float32, is_causal=s == 0, seed=s), 20 + s)
             for s in range(3)]
    tcfg = WanModelConfig(**DIMS)
    tnets = [WanDiffusion(cfg=tcfg, params=wan_params_from_jax(jax.device_get(j.params)),
                          fuse_qkv=False) for j in jnets]
    jcross = [jnets[0].compute_crossattn_cache(jnets[0].params, jax.random.normal(
        jax.random.PRNGKey(s), (1, 16, jcfg.text_dim), jnp.float32)) for s in (3, 4)]
    tcross = [tree_from_numpy(jax.device_get(c)) for c in jcross]
    return jnets, tnets, jcross, tcross


def _trainable(net):
    """A fresh trainable copy of a port net's params (grads start empty)."""
    return tlosses.trainable(jax.tree.map(lambda t: t.detach().clone(), net.params))


def _check_grads(tparams, jgrads):
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    tflat = tlosses.tree_leaves(tparams)
    assert set(jflat) == set(tflat)
    nonzero = 0
    for name, jg in jflat.items():
        tg = tflat[name].grad
        if not np.any(jg):
            assert tg is None or not torch.any(tg), name
            continue
        nonzero += 1
        assert tg is not None, name
        err = rel_fro(tg.numpy(), jg)
        assert err < REL, (name, err)
    assert nonzero > 0


def _noise(seed, shape=(1, F, 16, H, W)):
    """Test inputs, from numpy."""
    return jnp.asarray(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_loss_and_grads(loss_fn, params, *args, has_aux=True):
    """(loss, grads, draws) of loss_fn(params, *args): jitted
    `jax.value_and_grad`, and the draws it makes (`jax_draws`)."""
    draws = jax_draws(loss_fn, params, *args)
    out, grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=has_aux))(params, *args)
    return (out[0] if has_aux else out), grads, draws


DMD_CONFIG = dict(denoising_step_list=[1000, 500], num_frame_per_block=3, guidance_scale=2.0)


@pytest.mark.parametrize("steps,context_noise,same_step", [
    ([1000, 750, 500], 0, True), ([1000, 750, 500, 250], 100, False)])
def test_rollout_values_and_exit_flags(nets, steps, context_noise, same_step):
    jnets, tnets, jcross, tcross = nets
    jg, tg = jnets[0], tnets[0]
    noise = _noise(0)
    jpipe = JPipe(steps, jg.schedule, jg, num_frame_per_block=3, context_noise=context_noise,
                  same_step_across_blocks=same_step)
    run = lambda p, n, c, k: jpipe.inference_with_trajectory(p, n, c, k)  # noqa: E731
    args = (jg.params, noise, jcross[0], jax.random.PRNGKey(1))
    draws = ReplayDraws(jax_draws(run, *args))
    jpred, jflags = jax.jit(run)(*args)
    tpipe = SelfForcingTrainingPipeline(steps, tg.schedule, tg, num_frame_per_block=3,
                                        context_noise=context_noise,
                                        same_step_across_blocks=same_step)
    with torch.no_grad():
        tpred, tflags = tpipe.inference_with_trajectory(tg.params, t_(noise), tcross[0], draws)
    assert not draws.items
    assert tflags.tolist() == np.asarray(jflags).tolist()
    assert tuple(tpred.shape) == (1, F, 16, H, W)
    assert rel_fro(tpred.numpy(), jpred) < REL


def test_serving_cache_refuses_a_gradient_and_the_rollout_uses_the_training_cache(nets,
                                                                                  monkeypatch):
    _, tnets, _, tcross = nets
    tg = tnets[0]
    params = _trainable(tg)
    fsl = tg.cfg.frame_seq_length(H, W)
    x = torch.randn(1, 3, 16, H, W)
    t = torch.full((1, 3), 500.0)
    kv = kvc.init_kv_cache(tg.cfg.num_layers, 1, 6 * fsl, tg.cfg.num_heads, tg.cfg.head_dim,
                           torch.float32)
    with pytest.raises(RuntimeError, match="init_train_kv_cache"):
        tg.forward(x, tcross[0], t, kv, 0, "decode", 6 * fsl, params=params)
    made = []
    init = kvc.init_train_kv_cache
    monkeypatch.setattr(kvc, "init_train_kv_cache", lambda *a: made.append(init(*a)) or made[-1])
    pipe = SelfForcingTrainingPipeline([1000, 500], tg.schedule, tg, num_frame_per_block=3)
    draws = ReplayDraws([("randint", np.array([1, 0]))] + [
        ("normal", np.random.default_rng(i).normal(size=(1, 3, 16, H, W))) for i in range(2)])
    pred, flags = pipe.inference_with_trajectory(params, torch.randn(1, F, 16, H, W), tcross[0],
                                                 draws)
    pred.square().mean().backward()
    assert flags.tolist() == [1, 1] and len(made) == 1
    # block 0's refresh K/V (layer 0) sit in the cache with their graph
    assert [e[0] for e in made[0]["blocks"][0]] == [0, 3 * fsl]
    assert made[0]["blocks"][0][0][1].grad_fn is not None
    assert tlosses.tree_leaves(params)["blocks/self_attn/k/w"].grad.abs().sum() > 0
