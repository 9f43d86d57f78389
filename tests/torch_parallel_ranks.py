"""Rank functions of the port's parallel CPU tests (test_torch_parallel_*.py,
test_torch_sequence_parallel.py), run by `parallel/launch.run` over gloo.

A spawned rank imports this module, so it imports torch and the port only,
never JAX: the tests compute JAX's side in the pytest process and hand the
ranks numpy inputs; the ranks hand back numpy results.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from realtime_video_tpu_torch.config import WanModelConfig, load_server_config
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.parallel import collectives as coll
from realtime_video_tpu_torch.parallel import mesh as mesh_mod
from realtime_video_tpu_torch.parallel import plan
from realtime_video_tpu_torch.parallel import sequence, sharding
from realtime_video_tpu_torch.training import ema as ema_mod
from realtime_video_tpu_torch.training import losses as tlosses
from realtime_video_tpu_torch.training import train_step as tstep
from realtime_video_tpu_torch.utils.convert import tree_from_numpy, wan_params_from_jax


def _np(t):
    return t.detach().float().numpy().copy()


def _tree_np(tree):
    return {k: _np(v) for k, v in tlosses.tree_leaves(tree).items()}


class Replay:
    """Normal draws handed out in order (the JAX run's, made in the parent)."""

    def __init__(self, items):
        self.items = [np.asarray(a) for a in items]

    def noise(self, shape, dtype, device):
        a = self.items.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)


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


# ---------------------------------------------------------------------------
# planted faults: each must make its test fail
# ---------------------------------------------------------------------------


def _per_rank_rms(p, x, dim, group, eps=1e-5):
    """The q/k RMSNorm over this rank's shard alone (a per-rank mean)."""
    del dim, group
    return wan_dit.rms_norm(p, x, eps)


def _bias_every_rank(p, x, tp, lin):
    """The row-parallel bias added by every rank before the sum."""
    return coll.reduce_from_tp(lin(p, x), tp.group)


def _contiguous_shard_leaf(x, spec, tp_size, tp_rank, pieces=1,
                           _orig=sharding.shard_leaf):
    """A fused qkv split contiguously, JAX's addressable shard."""
    del pieces
    return _orig(x, spec, tp_size, tp_rank, 1)


def _dist_nn_all_reduce(x, group):
    """torch.distributed.nn's all_reduce, whose backward all-reduces too."""
    import torch.distributed.nn.functional as dnn

    return dnn.all_reduce(x, group=group)


FAULTS = {
    "per_rank_rms": (wan_dit, "rms_norm_tp", _per_rank_rms),
    "bias_every_rank": (wan_dit, "row_linear", _bias_every_rank),
    "contiguous_qkv": (sharding, "shard_leaf", _contiguous_shard_leaf),
    "dist_nn_all_reduce": (coll, "reduce_from_tp", _dist_nn_all_reduce),
}


@contextlib.contextmanager
def planted(fault):
    if fault is None:
        yield
        return
    mod, name, fn = FAULTS[fault]
    saved = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, saved)


# ---------------------------------------------------------------------------
# tensor parallelism: forwards and the denoise block
# ---------------------------------------------------------------------------


def _gen(cfg, tree, mesh, fused):
    return WanDiffusion(cfg=cfg, params=wan_params_from_jax(tree), mesh=mesh,
                        fuse_qkv=fused, device="cpu", dtype=torch.float32)


def tp_forwards(gen, c):
    """decode x0 and its cache, prefill flow and cache, train flow, the
    denoise block's x0, and the cross cache, on one generator."""
    f, fsl = c["frames"], c["fsl"]
    ctx, x = torch.from_numpy(c["ctx"]), torch.from_numpy(c["x"])
    t = torch.from_numpy(c["t"])
    cross = gen.compute_crossattn_cache(ctx)
    out = {"cross_k": _np(cross["k"])}
    kv = gen.init_kv_cache(1, 2 * f * fsl, torch.float32)
    _, x0, kv = gen.forward(x, cross, t, kv, 0, "decode", 2 * f * fsl)
    out.update(decode_x0=_np(x0), decode_k=_np(kv["k"]))
    if c.get("full", True):
        kv = gen.init_kv_cache(1, 2 * f * fsl, torch.float32)
        flow, kv = wan_dit.dit_forward(gen.cfg, gen.params, x, t, gen.rope, cross,
                                       mode="prefill", kv_cache=kv,
                                       prefill_block_tokens=fsl, layers=gen.layers,
                                       mesh=gen.mesh)
        out.update(prefill_flow=_np(flow), prefill_v=_np(kv["v"]))
        flow, _, _ = gen.forward(x, cross, t, mode="train")
        out["train_flow"] = _np(flow)
        fn = gen.make_denoise_block_fn(tuple(c["steps"]), 2 * f * fsl)
        kv = gen.init_kv_cache(1, 2 * f * fsl, torch.float32)
        x0, _ = fn(kv, cross, torch.from_numpy(c["noisy"]), 0, Replay(c["block_noise"]).noise)
        out["block_x0"] = _np(x0)
    return out


def serving_shards(c, mesh):
    """`plan.shard_for_serving` of the unfused tree with a KV and a cross
    cache, and with neither (None stays None)."""
    kv = {k: torch.from_numpy(c["serve_kv"][k]) for k in ("k", "v")}
    kv.update(global_end=3, local_end=2)
    cross = {k: torch.from_numpy(v) for k, v in c["serve_cross"].items()}
    params = wan_params_from_jax(c["params_unfused"])
    p, kv, cross = plan.shard_for_serving(params, kv, cross, mesh)
    out = {"params": _tree_np(p), "kv": {k: _np(v) if torch.is_tensor(v) else v
                                         for k, v in kv.items()},
           "cross": {k: _np(v) for k, v in cross.items()}}
    _, kv_none, cross_none = plan.shard_for_serving(params, None, None, mesh)
    out["none_caches"] = (kv_none, cross_none)
    return out


def tp_rank(rank, world, c):
    """Every case of test_torch_parallel_tp.py on one rank: per mesh, the
    fused tree's forwards, the int8 tree's decode and the serving shards;
    at the first mesh the
    unfused tree's decode, the planted faults and the MAX-reduced logit
    bound."""
    cfg = WanModelConfig(**c["dims"])
    res = {}
    for shape in c["meshes"]:
        mesh = mesh_mod.make_mesh(shape, "cpu")
        key = f"tp{shape['tp']}"
        res[key] = tp_forwards(_gen(cfg, c["params"], mesh, True), c)
        res[key + "_int8"] = tp_forwards(_gen(cfg, c["qparams"], mesh, True),
                                         dict(c, full=False))
        res[key + "_serving"] = serving_shards(c, mesh)
        if shape is c["meshes"][0]:
            res[key + "_unfused"] = tp_forwards(_gen(cfg, c["params_unfused"], mesh, False),
                                                dict(c, full=False))
            for fault in ("per_rank_rms", "bias_every_rank", "contiguous_qkv"):
                with planted(fault):
                    res[f"fault_{fault}"] = tp_forwards(_gen(cfg, c["params"], mesh, True),
                                                        dict(c, full=False))["decode_x0"]
            # the logit bound's maxima on this rank's heads, MAX-reduced over tp
            q, k = torch.from_numpy(c["bound_q"]), torch.from_numpy(c["bound_k"])
            n = q.shape[2] // shape["tp"]
            r = mesh_mod.axis_rank(mesh, "tp")
            m = hk.logit_bound_maxima_plain(q[:, :, r * n:(r + 1) * n],
                                            k[:, :, r * n:(r + 1) * n], q.shape[-1] ** -0.5)
            res["bound_local"] = _np(m)
            res["bound_reduced"] = _np(coll.all_reduce_max_(m, mesh_mod.axis_group(mesh, "tp")))
    res["rank"] = rank
    return res


# ---------------------------------------------------------------------------
# the dp x tp training step
# ---------------------------------------------------------------------------


def train_rank(rank, world, c):
    """One dp x tp flow-matching step with the EMA, one without, one with a
    planted fault; this rank's leaves, Adam moments and shadow."""
    cfg = WanModelConfig(**c["dims"])
    mesh = mesh_mod.make_mesh(c["mesh"], "cpu")
    lat, emb = torch.from_numpy(c["latents"]), torch.from_numpy(c["embeds"])
    res = {"tp_rank": mesh_mod.axis_rank(mesh, "tp"), "dp_rank": mesh_mod.axis_rank(mesh, "dp")}
    for name, ema_decay, fault in (("ema", 0.9, None), ("plain", None, None),
                                   ("fault_dist_nn_all_reduce", None, "dist_nn_all_reduce")):
        gen = WanDiffusion(cfg=cfg, params=wan_params_from_jax(c["params"]), fuse_qkv=False,
                           device="cpu", dtype=torch.float32)
        params, opt = tstep.make_train_state(gen, mesh, learning_rate=c["lr"])
        shadow = ema_mod.init_ema(params) if ema_decay is not None else None
        step = tstep.make_train_step(gen, opt, mesh, ema_decay=ema_decay)
        losses = []
        with planted(fault):
            for rec in c["records"]:
                losses.append(step(params, lat, emb, ReplayDraws(rec), ema=shadow)["loss"].item())
        leaves = tlosses.tree_leaves(params)
        res[name] = {"params": _tree_np(params), "loss": losses,
                     "mu": {k: _np(opt.state[v]["exp_avg"]) for k, v in leaves.items()},
                     "nu": {k: _np(opt.state[v]["exp_avg_sq"]) for k, v in leaves.items()}}
        if shadow is not None:
            res[name]["ema"] = _tree_np(shadow)
    return res


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


def sp_rank(rank, world, c):
    """Ulysses, ring and USP on this rank's shards of the cases' q/k/v, and
    the teacher pipeline with sp_mesh."""
    res = {}
    for name, kind, shape, arrays in c["attention"]:
        mesh = mesh_mod.make_mesh(shape, "cpu")
        axes = ("sp_r", "sp_u") if kind == "usp" else "sp"
        q, k, v = (sequence.shard_sequence(torch.from_numpy(a), mesh, axes) for a in arrays)
        make = {"ulysses": sequence.make_sp_attention, "ring": sequence.make_ring_attention,
                "usp": sequence.make_usp_attention}[kind]
        attn = make(mesh) if kind != "usp" else make(mesh, "sp_u", "sp_r")
        out = attn(q, k, v)
        res[name] = _np(coll.all_gather(out, 1, attn.gather_group))
    if "teacher" in c:
        t = c["teacher"]
        cfg = WanModelConfig(**t["dims"])
        mesh = mesh_mod.make_mesh({"sp": world}, "cpu")
        from realtime_video_tpu_torch.pipelines.bidirectional_diffusion_inference import (
            BidirectionalDiffusionInferencePipeline,
        )

        gen = WanDiffusion(cfg=cfg, params=wan_params_from_jax(t["params"]), device="cpu",
                           dtype=torch.float32)
        config = load_server_config(guidance_scale=3.0, sampling_steps=t["steps"])
        pipe = BidirectionalDiffusionInferencePipeline(config, gen, sp_mesh=mesh)
        mesh2 = pipe.usp_mesh
        res["teacher_mesh"] = {"sp_r": mesh_mod.axis_size(mesh2, "sp_r"),
                               "sp_u": mesh_mod.axis_size(mesh2, "sp_u")}
        emb = tree_from_numpy(t["embeds"])
        _, lat = pipe.inference(torch.from_numpy(t["noise"]), prompt_embeds=emb[0],
                                neg_prompt_embeds=emb[1], return_latents=True)
        res["teacher"] = _np(lat)
        if rank == 0:
            ref = BidirectionalDiffusionInferencePipeline(config, gen)
            _, lat1 = ref.inference(torch.from_numpy(t["noise"]), prompt_embeds=emb[0],
                                    neg_prompt_embeds=emb[1], return_latents=True)
            res["teacher_single"] = _np(lat1)
    res["world"] = dist.get_world_size()
    return res


def hang_rank(rank, world, seconds):
    """Rank 1 sleeps past the launcher's timeout."""
    import time

    if rank == 1:
        time.sleep(seconds)
    return rank
