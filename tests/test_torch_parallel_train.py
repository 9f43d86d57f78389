"""The port's dp x tp flow-matching train step against the JAX package's
`make_train_step` on a {"dp": 2, "tp": 2} mesh, on the CPU in f32.

A tiny model (dim 64, 4 heads, 2 layers, random head and biases), a batch
of 2 (6 latent frames of 4x4), lr 1e-3: one step with the EMA (decay 0.9)
and one without. JAX's loss draws are recorded in call order
(`test_torch_training.jax_draws`) at the whole batch's shapes, and each of
the port's 4 ranks (one `parallel/launch.run` over gloo,
`torch_parallel_ranks.train_rank`) replays them through
`DataParallelDraws`, keeping its dp rows.

Every leaf of each rank's tp slice, its Adam moments and its EMA shadow
equal the same slice of JAX's (`sharding.shard_params`; one JAX step with
the EMA: the EMA only reads the params, so its params and moments are the
step's without it) at relative
Frobenius 1e-5, `REL` of test_torch_train_step.py; the dp copies are equal
bit for bit, and so are the replicated leaves over the tp ranks. A planted
fault, `torch.distributed.nn.functional.all_reduce` in place of
`reduce_from_tp` (its backward all-reduces a replicated gradient again,
scaling it by tp), must move the result past 1e-3.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from realtime_video_tpu.config import WanModelConfig as JCfg
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.training import ema as jema
from realtime_video_tpu.training import losses as jlosses
from realtime_video_tpu.training import train_step as jstep
from realtime_video_tpu_torch.parallel import launch
from realtime_video_tpu_torch.parallel import sharding as tsh
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax
from test_torch_training import jax_draws, rel_fro
from torch_parallel_ranks import train_rank

DIMS = dict(dim=64, ffn_dim=128, num_heads=4, num_layers=2)
REL = 1e-5
LR = 1e-3


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def run():
    cfg = JCfg(**DIMS)
    p = jdit.init_wan_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    p["head"]["head"]["w"] = jnp.asarray(rng.normal(0, 0.05, p["head"]["head"]["w"].shape),
                                         jnp.float32)
    p["blocks"] = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        if getattr(path[-1], "key", None) == "b" else a, p["blocks"])
    lat = jnp.asarray(rng.normal(size=(2, 6, 16, 4, 4)), jnp.float32)
    emb = jnp.asarray(rng.normal(size=(2, 16, cfg.text_dim)), jnp.float32)
    keys = [jax.random.PRNGKey(30)]
    draw_gen = JGen(cfg=cfg, params=p, dtype=jnp.float32)
    records = [jax_draws(lambda q, k=k: jlosses.causal_flow_matching_loss(draw_gen, q, lat, emb,
                                                                         k), p) for k in keys]

    whole = jax.device_get(p)
    case = dict(dims=DIMS, mesh={"dp": 2, "tp": 2}, params=whole, lr=LR,
                latents=np.asarray(lat), embeds=np.asarray(emb), records=records)
    # the ranks run while JAX compiles its step
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.run, train_rank, 4, case, backend="gloo", device="cpu",
                            timeout_s=240)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
        # JAX's step with the EMA: the EMA only reads the params, so its
        # params and moments are the step's without it too
        jgen = JGen(cfg=cfg, params=jax.tree.map(jnp.array, whole), dtype=jnp.float32)
        params, tx, opt = jstep.make_train_state(jgen, mesh, learning_rate=LR)
        shadow = jema.init_ema(params)
        step = jstep.make_train_step(jgen, tx, mesh, ema_decay=0.9)
        params, opt, shadow, _ = step(params, opt, lat, emb, keys[0], ema=shadow)
        plain = {"params": _flat(params), "mu": _flat(opt[0].mu), "nu": _flat(opt[0].nu)}
        want = {"plain": plain, "ema": dict(plain, ema=_flat(shadow))}
        ranks = ranks.result()
    return ranks, want, wan_params_from_jax(whole)


def _slice(flat, like, tp_rank):
    """JAX's whole leaves sliced as the port's rank `tp_rank` holds them."""
    tree = {}
    for name, a in flat.items():  # rebuild the nested tree for the specs
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(np.array(a))
    specs = tsh.wan_param_pspecs(like)
    out = tsh.shard_params(tree, specs, 2, tp_rank)
    from realtime_video_tpu_torch.training.losses import tree_leaves

    return {k: v.numpy() for k, v in tree_leaves(out).items()}


@pytest.mark.parametrize("name", ["ema", "plain"])
def test_dp_tp_step_matches_jax(run, name):
    ranks, want, like = run
    for r in ranks:
        got = r[name]
        assert np.isfinite(got["loss"]).all()
        parts = ["params", "mu", "nu"] + (["ema"] if name == "ema" else [])
        for part in parts:
            sliced = _slice(want[name][part], like, r["tp_rank"])
            assert set(got[part]) == set(sliced)
            for leaf, w in sliced.items():
                assert rel_fro(got[part][leaf], w) < REL, (name, part, leaf, r["tp_rank"],
                                                          rel_fro(got[part][leaf], w))


def test_dp_copies_and_replicated_leaves_are_bit_equal(run):
    ranks, _, like = run
    specs = {k: v for k, v in _leaf_specs(like).items()}
    by = {(r["dp_rank"], r["tp_rank"]): r["ema"]["params"] for r in ranks}
    for tp in (0, 1):
        for leaf, a in by[(0, tp)].items():
            assert np.array_equal(a, by[(1, tp)][leaf]), leaf
    for leaf, spec in specs.items():
        if "tp" not in spec:
            assert np.array_equal(by[(0, 0)][leaf], by[(0, 1)][leaf]), leaf


def _leaf_specs(like):
    from realtime_video_tpu_torch.training.losses import tree_leaves

    specs = tsh.wan_param_pspecs(like)
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = node

    walk(specs, "")
    assert set(flat) == set(tree_leaves(like))
    return flat


def test_dist_nn_all_reduce_in_place_of_reduce_from_tp_fails(run):
    ranks, want, like = run
    got = ranks[0]["fault_dist_nn_all_reduce"]
    sliced = {part: _slice(want["plain"][part], like, ranks[0]["tp_rank"])
              for part in ("params", "mu")}
    worst = max(rel_fro(got[part][leaf], w) for part in sliced for leaf, w in sliced[part].items())
    assert worst > 1e-3, worst
