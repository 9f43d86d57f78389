"""The port's tensor-parallel splits against the JAX package's shardings,
its memory plan at tp, and the launcher's timeout, on the CPU.

  * specs: the port's `wan_param_pspecs` equals JAX's (PartitionSpecs as
    tuples) leaf for leaf, unfused, fused, int8 (with and without static
    activation scales) and i2v; `t5_param_pspecs` likewise;
  * shards: rank r's slice of every leaf (`sharding.shard_params`) is bit
    for bit the JAX `addressable_shards` entry of the device at tp = r on a
    {"dp": 1, "tp": tp} mesh, tp 2 and 4; a fused qkv's slice (w, or w_q,
    scale and b) is JAX's unfused q, k and v shards side by side; every int8
    `w_q` slice is K-major again (strides (1, K) a layer); the KV cache's
    slices are JAX's;
  * the plan: every field of `serving_memory_plan(cfg, tp)` equals JAX's at
    tp 1 / 2 / 4 / 8 for t2v-1.3B and t2v-14B;
  * `launch.run`: a rank that hangs fails the run within its timeout, and
    NCCL with fewer cards than ranks is refused before any rank starts.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from realtime_video_tpu.config import WAN_CONFIGS as J_CONFIGS
from realtime_video_tpu.config import WanModelConfig as JCfg
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.ops import kv_cache as jkvc
from realtime_video_tpu.parallel import plan as jplan
from realtime_video_tpu.parallel import sharding as jsh
from realtime_video_tpu_torch.config import WAN_CONFIGS
from realtime_video_tpu_torch.parallel import launch
from realtime_video_tpu_torch.parallel import plan as tplan
from realtime_video_tpu_torch.parallel import sharding as tsh
from realtime_video_tpu_torch.training.losses import tree_leaves
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax
from torch_parallel_ranks import hang_rank

DIMS = dict(dim=64, ffn_dim=128, num_heads=4, num_layers=2)
FIELDS = ("dit_params", "kv_cache", "crossattn_cache", "activations", "total")


def _spec_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


@functools.lru_cache(maxsize=None)
def _trees(model_type="t2v"):
    cfg = JCfg(**DIMS, model_type=model_type, in_dim=36 if model_type == "i2v" else 16)
    p = jdit.init_wan_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), p)
    acts = {(g, n): np.full((DIMS["num_layers"],), 2.0)
            for g, n in (("self_attn", "q"), ("ffn", "fc2"), ("cross_attn", "o"))}
    return {"unfused": p, "fused": jdit.fuse_qkv_params(p),
            "int8": jdit.quantize_wan_linears(p),
            "int8_static": jdit.quantize_wan_linears(p, act_scales=acts),
            "int8_fused": jdit.quantize_wan_linears(jdit.fuse_qkv_params(p))}


@pytest.mark.parametrize("kind", ["unfused", "fused", "int8", "int8_static", "int8_fused",
                                  "i2v"])
def test_specs_match_jax(kind):
    trees = _trees("i2v" if kind == "i2v" else "t2v")
    jtree = trees["unfused" if kind == "i2v" else kind]
    want = _flat(_spec_tuples(jsh.wan_param_pspecs(jtree)))
    got = _flat(tsh.wan_param_pspecs(wan_params_from_jax(jax.device_get(jtree))))
    assert got == want


def test_t5_specs_match_jax():
    # both read the tree's structure from the config, not from the params
    want = _flat(_spec_tuples(jsh.t5_param_pspecs(None)))
    assert _flat(tsh.t5_param_pspecs(None)) == want


def _jax_shard(leaf, mesh, r):
    """The data of `leaf`'s addressable shard on the device at tp = r."""
    dev = mesh.devices[0, r]
    (shard,) = [s for s in leaf.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["fused", "int8_fused", "int8"])
def test_shards_equal_jax_addressable_shards(tp, kind):
    trees = _trees()
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    unfused = "unfused" if kind == "fused" else "int8"
    jshards = jsh.shard_wan_params(trees[unfused], mesh)
    jflat = {k: v for k, v in _flat(jshards).items()}
    port = wan_params_from_jax(jax.device_get(trees[kind]))
    specs = tsh.wan_param_pspecs(port)
    for r in range(tp):
        got = tree_leaves(tsh.shard_params(port, specs, tp, r))
        for name, t in got.items():
            if "/qkv/" in name:  # q, k and v shards side by side
                leaf = name.rsplit("/", 1)[1]
                if leaf == "a_scale":
                    want = _jax_shard(jflat[name.replace("qkv", "q")], mesh, r)
                else:
                    want = np.concatenate([_jax_shard(jflat[name.replace("qkv", n)], mesh, r)
                                           for n in "qkv"], axis=-1)
            else:
                want = _jax_shard(jflat[name], mesh, r)
            assert np.array_equal(t.numpy(), want), (name, r)
            if name.endswith("w_q"):
                for layer in t.unbind(0):
                    assert layer.stride() == (1, layer.shape[0]), (name, layer.stride())


@pytest.mark.parametrize("tp", [2, 4])
def test_kv_cache_shards_equal_jax(tp):
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    kv = jkvc.init_kv_cache(2, 1, 32, 4, 16, jnp.float32)
    kv = {**kv, "k": jnp.asarray(np.random.default_rng(3).normal(size=kv["k"].shape),
                                 jnp.float32)}
    jkv = jsh.shard_kv_cache(kv, mesh)
    spec = tsh.kv_cache_sharding()["k"]
    for r in range(tp):
        got = tsh.shard_leaf(torch.from_numpy(np.asarray(kv["k"])), spec, tp, r)
        assert np.array_equal(got.numpy(), _jax_shard(jkv["k"], mesh, r))


@pytest.mark.parametrize("model", ["t2v-1.3B", "t2v-14B"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_plan_matches_jax_at_tp(model, tp):
    want = jplan.serving_memory_plan(J_CONFIGS[model], tp=tp)
    got = tplan.serving_memory_plan(WAN_CONFIGS[model], tp=tp)
    assert {f: getattr(got, f) for f in FIELDS} == {f: getattr(want, f) for f in FIELDS}
    assert got.fits() == (got.total <= (1 - tplan.RESERVE_FRAC) * tplan.H100_BYTES)


def test_launch_fails_a_hung_rank_within_its_timeout():
    # rank 1 sleeps past the timeout; on a loaded host rank 0 may not have
    # finished its start-up by then either, so the message may name both
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2 did not finish within 4"):
        launch.run(hang_rank, 2, 300, backend="gloo", device="cpu", timeout_s=4)
    assert time.monotonic() - t0 < 4 + 20  # the timeout, then killing and joining


def test_launch_refuses_nccl_without_a_card_a_rank():
    with pytest.raises(RuntimeError, match="NCCL needs a card a rank"):
        launch.run(hang_rank, max(2, torch.cuda.device_count() + 1), 0)
