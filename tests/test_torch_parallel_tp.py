"""The port's tensor-parallel DiT against the JAX package's GSPMD-sharded
one and against its own tp = 1, on tests/test_multichip.py's tiny model
(dim 64, 4 heads, 2 layers, a random head) in f32 on the CPU.

One `parallel/launch.run` of 4 ranks over gloo (`torch_parallel_ranks.tp_rank`)
runs, on a {"dp": 2, "tp": 2} and a {"dp": 1, "tp": 4} mesh: the decode
forward and its KV cache, the prefill forward and its cache, the train-mode
forward, the serving denoise block (2 steps, JAX's renoise draws replayed),
the cross-attention cache, each on the fused tree; `plan.shard_for_serving`
of the unfused tree and two caches; the decode forward on the
int8 tree (dynamic activation scales, so the row-parallel linears quantise
with the tp group's MAX); and, at tp 2, the decode forward on the unfused
tree and the planted faults. JAX's side runs in this process on conftest's CPU devices,
its params, caches and inputs sharded over a {"dp": 1, "tp": 4} mesh.

Bars: test_multichip.py's, rtol = atol = 1e-4 for the forwards, 2e-4 for
the denoise block, and for the int8 forward the port's looser port-vs-JAX
bar (relative Frobenius 1e-3, tests/test_torch_int8_dit.py); against
the port's own tp = 1, relative Frobenius 1e-5 (the tp sum of the
row-parallel partial products rounds once a rank, so tp is not bit-equal to
one device). Every rank's x0 is the same bit for bit. The biases are random
(the init's are zero). Each planted fault (a per-rank RMS mean, the row-parallel bias
added on every rank, a contiguous fused-qkv split) must move x0 past 1e-3.
The logit bound's maxima, MAX-reduced over tp from each rank's heads, equal
the unsharded maxima exactly.
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
from realtime_video_tpu.ops import kv_cache as jkvc
from realtime_video_tpu.parallel.plan import shard_for_serving
from realtime_video_tpu.parallel.sharding import shard_kv_cache, shard_wan_params
from realtime_video_tpu_torch.config import WanModelConfig
from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.parallel import launch
from torch_parallel_ranks import _gen, tp_forwards, tp_rank

DIMS = dict(dim=64, ffn_dim=128, num_heads=4, num_layers=2)
F, C, LAT = 3, 16, 8
FSL = 16
STEPS = (1000.0, 500.0)
MESHES = [{"dp": 2, "tp": 2}, {"dp": 1, "tp": 4}]
REL = 1e-5
#: the port's int8 forward against JAX's (tests/test_torch_int8_dit.py):
#: an f32 difference in an activation can move its quantum by one
INT8_JAX_REL = 1e-3


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _params():
    cfg = JCfg(**DIMS)
    p = jdit.init_wan_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    p["head"]["head"]["w"] = jnp.asarray(rng.normal(0, 0.05, p["head"]["head"]["w"].shape),
                                         jnp.float32)
    # nonzero biases (the init's are zero), so that a bias added twice shows
    p["blocks"] = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        if getattr(path[-1], "key", None) == "b" else a, p["blocks"])
    return cfg, p


@pytest.fixture(scope="module")
def run():
    jcfg, p = _params()
    fused = jdit.fuse_qkv_params(p)
    q8 = jdit.quantize_wan_linears(fused)
    rng = np.random.default_rng(1)
    ctx = rng.normal(size=(1, 16, jcfg.text_dim)).astype(np.float32)
    x = rng.normal(size=(1, F, C, LAT, LAT)).astype(np.float32)
    noisy = rng.normal(size=(1, F, C, LAT, LAT)).astype(np.float32)
    t = np.full((1, F), 500.0, np.float32)
    key = jax.random.PRNGKey(5)
    block_noise, k = [], key
    for _ in STEPS:  # the denoise block's renoise draws, as its scan splits them
        k, sub = jax.random.split(k)
        block_noise.append(np.asarray(jax.random.normal(sub, x.shape, jnp.float32)))
    bq = rng.normal(size=(1, 32, 4, 16)).astype(np.float32) * np.array(
        [1.0, 2.5, 0.5, 1.5], np.float32)[None, None, :, None]
    bk = rng.normal(size=(1, 48, 4, 16)).astype(np.float32)
    cache = (jcfg.num_layers, 1, 2 * F * FSL, jcfg.num_heads, jcfg.head_dim)
    serve_kv = {k: rng.normal(size=cache).astype(np.float32) for k in ("k", "v")}
    serve_cross = {k: rng.normal(size=(*cache[:2], 16, *cache[3:])).astype(np.float32)
                   for k in ("k", "v")}

    case = dict(dims=DIMS, meshes=MESHES, frames=F, fsl=FSL, steps=STEPS,
                params=jax.device_get(fused), params_unfused=jax.device_get(p),
                qparams=jax.device_get(q8), ctx=ctx, x=x, t=t, noisy=noisy,
                block_noise=block_noise, bound_q=bq, bound_k=bk, serve_kv=serve_kv,
                serve_cross=serve_cross)
    # the ranks run while JAX compiles
    pool = ThreadPoolExecutor(1)
    pending = pool.submit(launch.run, tp_rank, 4, case, backend="gloo", device="cpu",
                          timeout_s=240)
    # JAX: params, caches and inputs on a {"dp": 1, "tp": 4} mesh
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("dp", "tp"))
    jgen = JGen(cfg=jcfg, params=fused, dtype=jnp.float32)
    kv0 = jkvc.init_kv_cache(jcfg.num_layers, 1, 2 * F * FSL, jcfg.num_heads, jcfg.head_dim,
                             jnp.float32)
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    jcross = jax.jit(jgen.compute_crossattn_cache)(shard_wan_params(fused, mesh),
                                                   jnp.asarray(ctx))

    def decode(params, kv):
        _, x0, kv = jgen.forward(params, jx, jcross, jt, kv_cache=kv, current_start=0,
                                 mode="decode", max_attention_size=2 * F * FSL)
        return x0, kv

    def prefill(params, kv):
        return jdit.dit_forward(jcfg, params, jx, jt, jgen.rope, jcross, mode="prefill",
                                kv_cache=kv, prefill_block_tokens=FSL)

    def train(params):
        return jgen.forward(params, jx, jcross, jt, mode="train")[0]

    sp = shard_wan_params(fused, mesh)
    want = {}
    want["decode_x0"], kv = jax.jit(decode)(sp, shard_kv_cache(kv0, mesh))
    want["decode_k"] = kv["k"]
    want["prefill_flow"], kv = jax.jit(prefill)(sp, shard_kv_cache(kv0, mesh))
    want["prefill_v"] = kv["v"]
    want["train_flow"] = jax.jit(train)(sp)
    fn = jgen.make_denoise_block_fn(STEPS, 2 * F * FSL)
    want["block_x0"] = jax.jit(fn)(sp, shard_kv_cache(kv0, mesh), jcross,
                                   jnp.asarray(noisy), 0, key)[0]
    want["int8_decode_x0"] = jax.jit(decode)(shard_wan_params(q8, mesh),
                                             shard_kv_cache(kv0, mesh))[0]
    want["cross_k"] = jcross["k"]
    want = {k: np.asarray(v) for k, v in want.items()}
    ranks = pending.result()
    pool.shutdown()
    # the port's own one-device forwards, in this process
    cfg = WanModelConfig(**DIMS)
    one = tp_forwards(_gen(cfg, case["params"], None, True), case)
    one["int8_decode_x0"] = tp_forwards(_gen(cfg, case["qparams"], None, True),
                                        dict(case, full=False))["decode_x0"]
    return ranks, want, one, case


def _tp_ranks(ranks, tp):
    """The ranks of one tp group (dp rank 0), in tp order."""
    return ranks[:tp]


def _whole(ranks, tp, key, name, head_dim=3):
    """A head-sharded result put together from the tp group's ranks."""
    return np.concatenate([r[key][name] for r in _tp_ranks(ranks, tp)], axis=head_dim)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name, bar", [("decode_x0", 1e-4), ("prefill_flow", 1e-4),
                                       ("train_flow", 1e-4), ("block_x0", 2e-4)])
def test_tp_forward_matches_jax_and_one_device(run, tp, name, bar):
    ranks, want, one, _ = run
    got = ranks[0][f"tp{tp}"][name]
    np.testing.assert_allclose(got, want[name], rtol=bar, atol=bar)
    assert rel_fro(got, one[name]) < REL
    for r in ranks:  # replicated: every rank, dp copies too, bit for bit
        assert np.array_equal(r[f"tp{tp}"][name], got), (name, r["rank"])


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_caches_hold_local_heads(run, tp):
    """The decode and prefill caches and the cross-attention cache hold the
    rank's heads; put together they are JAX's and one device's."""
    ranks, want, one, _ = run
    for key, name in (("decode_k", "decode_k"), ("prefill_v", "prefill_v"),
                      ("cross_k", "cross_k")):
        shard = ranks[0][f"tp{tp}"][name]
        assert shard.shape[3] == DIMS["num_heads"] // tp
        whole = _whole(ranks, tp, f"tp{tp}", name)
        np.testing.assert_allclose(whole, want[key], rtol=1e-4, atol=1e-4)
        assert rel_fro(whole, one[name]) < REL


def _jax_shard(leaf, mesh, r):
    """The data of `leaf`'s addressable shard on the device at tp = r."""
    (shard,) = [s for s in leaf.addressable_shards if s.device == mesh.devices[0, r]]
    return np.asarray(shard.data)


def _paths(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_for_serving_matches_jax(run, tp):
    """plan.shard_for_serving on each rank of a tp group: every param leaf
    and the KV and cross caches' heads bit for bit JAX's shard_for_serving
    addressable shards at tp = rank; the cache ends pass through; None
    caches stay None."""
    ranks, _, _, case = run
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    kv = {**{k: jnp.asarray(v) for k, v in case["serve_kv"].items()},
          "global_end": jnp.int32(3), "local_end": jnp.int32(2)}
    cross = {k: jnp.asarray(v) for k, v in case["serve_cross"].items()}
    jp, jkv, jcross = shard_for_serving(jax.tree.map(jnp.asarray, case["params_unfused"]),
                                        kv, cross, mesh)
    jflat = _paths(jp)
    for r, rank in enumerate(_tp_ranks(ranks, tp)):
        got = rank[f"tp{tp}_serving"]
        assert got["params"].keys() == jflat.keys()
        for name, leaf in got["params"].items():
            assert np.array_equal(leaf, _jax_shard(jflat[name], mesh, r)), (name, r)
        for part, want in (("kv", jkv), ("cross", jcross)):
            for k in ("k", "v"):
                assert got[part][k].shape[3] == DIMS["num_heads"] // tp
                assert np.array_equal(got[part][k], _jax_shard(want[k], mesh, r)), (part, k, r)
        assert (got["kv"]["global_end"], got["kv"]["local_end"]) == (3, 2)
        assert got["none_caches"] == (None, None)


def test_tp_unfused_forward(run):
    ranks, _, one, _ = run
    assert rel_fro(ranks[0]["tp2_unfused"]["decode_x0"], one["decode_x0"]) < REL


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_int8_forward(run, tp):
    """The int8 tree's decode (dynamic scales: the row-parallel amax is the
    tp group's MAX) against JAX's and one device's."""
    ranks, want, one, _ = run
    got8 = ranks[0][f"tp{tp}_int8"]["decode_x0"]
    assert rel_fro(got8, want["int8_decode_x0"]) < INT8_JAX_REL
    assert rel_fro(got8, one["int8_decode_x0"]) < REL
    for r in ranks:
        assert np.array_equal(r[f"tp{tp}_int8"]["decode_x0"], got8)


@pytest.mark.parametrize("fault", ["per_rank_rms", "bias_every_rank", "contiguous_qkv"])
def test_planted_faults_fail(run, fault):
    ranks, want, one, _ = run
    got = ranks[0][f"fault_{fault}"]
    assert rel_fro(got, one["decode_x0"]) > 1e-3, fault
    assert not np.allclose(got, want["decode_x0"], rtol=1e-4, atol=1e-4)


def test_logit_bound_max_reduced_over_tp(run):
    ranks, _, _, case = run
    q, k = torch.from_numpy(case["bound_q"]), torch.from_numpy(case["bound_k"])
    whole = hk.logit_bound_maxima_plain(q, k, q.shape[-1] ** -0.5).numpy()
    for r in ranks:
        assert np.array_equal(r["bound_reduced"], whole)
    # the heads differ in scale: one rank's own maxima are smaller
    assert any(not np.array_equal(r["bound_local"], whole) for r in ranks)
