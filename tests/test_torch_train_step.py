"""The port's train step against the JAX package's, and train.py's CLI.

  * AdamW + EMA alone: the same gradients fed to `torch.optim.AdamW` (the
    port's `adamw`) and to `optax.adamw`, two steps, then `ema_update`
    against JAX's: params, Adam's moments and the shadow at relative
    Frobenius 1e-5 (f32);
  * the whole step: two `make_train_step` steps (the causal flow-matching
    loss, its backward, AdamW, the f32 EMA) against JAX's `make_train_step`
    on a 1 x 1 mesh, the loss's draws replayed: params and the shadow at
    1e-5;
  * `python -m realtime_video_tpu_torch.train --tiny --device cpu --steps 2`
    runs with finite, nonzero losses and gradient norms, and two steps
    straight equal one step, a checkpoint and a resumed step, bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from realtime_video_tpu.training import ema as jema
from realtime_video_tpu.training import losses as jlosses
from realtime_video_tpu.training import train_step as jstep
from realtime_video_tpu_torch import train as train_mod
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.training import ema as tema
from realtime_video_tpu_torch.training import losses as tlosses
from realtime_video_tpu_torch.training import train_step as tstep
from test_torch_training import ReplayDraws, _noise, jax_draws, nets, rel_fro  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
REL = 1e-5


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(torch_tree, jax_tree, rel=REL):
    tflat = {k: v.detach().numpy() for k, v in tlosses.tree_leaves(torch_tree).items()}
    jflat = _flat(jax_tree)
    assert set(tflat) == set(jflat)
    for k, want in jflat.items():
        assert rel_fro(tflat[k], want) < rel, (k, rel_fro(tflat[k], want))


def test_adamw_and_ema_match_optax_on_the_same_gradients(nets):
    jnets, tnets, _, _ = nets
    jparams = jnets[0].params
    grads = [jax.tree.map(lambda p, s=s: jnp.asarray(np.random.default_rng(s).normal(
        size=p.shape).astype(np.float32)), jparams) for s in (1, 2)]
    tx = optax.adamw(1e-3, weight_decay=0.01)
    opt_state = tx.init(jparams)
    shadow = jema.init_ema(jparams)
    tparams = tlosses.trainable(jax.tree.map(lambda t: t.detach().clone(), tnets[0].params))
    topt = tstep.adamw(tparams, 1e-3, 0.01)
    tshadow = tema.init_ema(tparams)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        shadow = jema.ema_update(shadow, jparams, 0.9)
        gflat = _flat(g)
        for name, leaf in tlosses.tree_leaves(tparams).items():
            leaf.grad = torch.from_numpy(gflat[name].copy())
        topt.step()
        tema.ema_update(tshadow, tparams, 0.9)
    _close(tparams, jparams)
    _close(tshadow, shadow)
    assert all(t.dtype == torch.float32 for t in tlosses.tree_leaves(tshadow).values())
    mu = _flat(opt_state[0].mu)
    for name, leaf in tlosses.tree_leaves(tparams).items():
        assert rel_fro(topt.state[leaf]["exp_avg"].numpy(), mu[name]) < REL
    back = tema.ema_params(tshadow, tparams)
    assert all(b.dtype == p.dtype for b, p in zip(tlosses.tree_leaves(back).values(),
                                                   tlosses.tree_leaves(tparams).values()))


def test_train_step_matches_jax(nets):
    jnets, tnets, _, _ = nets
    jgen, tgen = jnets[0], tnets[0]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    jparams, tx, jopt = jstep.make_train_state(jgen, mesh, learning_rate=1e-3)
    jrun = jstep.make_train_step(jgen, tx, mesh, ema_decay=0.9)
    shadow = jema.init_ema(jparams)
    lat = _noise(21)
    emb = _noise(22, (1, 16, jgen.cfg.text_dim))
    keys = [jax.random.PRNGKey(30 + i) for i in range(2)]
    records = [jax_draws(lambda p, k=k: jlosses.causal_flow_matching_loss(jgen, p, lat, emb, k),
                         jgen.params) for k in keys]
    for k in keys:
        jparams, jopt, shadow, _ = jrun(jparams, jopt, lat, emb, k, ema=shadow)

    tgen = WanDiffusion(cfg=tgen.cfg, params=jax.tree.map(lambda t: t.detach().clone(),
                                                          tgen.params), fuse_qkv=False)
    tparams, opt = tstep.make_train_state(tgen, learning_rate=1e-3)
    tshadow = tema.init_ema(tparams)
    trun = tstep.make_train_step(tgen, opt, ema_decay=0.9)
    for rec in records:
        metrics = trun(tparams, torch.from_numpy(np.array(lat)), torch.from_numpy(np.array(emb)),
                       ReplayDraws(rec), ema=tshadow)
        assert np.isfinite(metrics["loss"].item())
    _close(tparams, jparams)
    _close(tshadow, shadow)


def _train(argv):
    return train_mod.main(["--tiny", "--device", "cpu", "--text-encoder", "seeded",
                           "--config", train_mod.TRAIN_CONFIG, *argv])


def test_train_cli_runs_and_resumes_bit_equal(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "realtime_video_tpu_torch.train", "--tiny",
                           "--device", "cpu", "--steps", "2", "--text-encoder", "seeded"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stderr.count("INFO:realtime_video_tpu_torch.train:step") + \
        proc.stderr.count("INFO:__main__:step") == 2, proc.stderr[-2000:]

    straight = _train(["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    assert len(straight) == 2
    for rec in straight:
        for key in ("gen_loss", "critic_loss", "gen_grad_norm", "critic_grad_norm"):
            assert np.isfinite(rec[key]) and rec[key] != 0, (key, rec)
    _train(["--steps", "1", "--ckpt-dir", str(tmp_path / "b")])
    resumed = _train(["--steps", "2", "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert [r["step"] for r in resumed] == [1]
    a = torch.load(tmp_path / "a" / "step_2.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "step_2.pt", weights_only=True)
    for net in ("generator", "fake_score"):
        assert a[net].keys() == b[net].keys()
        for k in a[net]:
            assert torch.equal(a[net][k], b[net][k]), (net, k)
    assert resumed[0]["gen_loss"] == straight[1]["gen_loss"]


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.build(train_mod.parse_args(["--tiny", "--steps", "1"]))
