"""The multi-GPU phases of chip_smoke.py: tensor parallelism (tp), the dp x tp
training step and the sequence-parallel ring's composition, on one card and,
where the host has two or more, over NCCL.

On one card the tp and dp x tp phases run their ranks as processes that
share the card over gloo (`parallel/launch.run(backend="gloo")`): every rank
launches its kernels at its sharded shapes, and the collectives they need
are all-reduces, which gloo takes on CUDA tensors (`collectives.
gloo_takes_cuda` probes it; a build that refuses them fails the phase).
Their wall times are of ranks sharing one card, not a speed figure. The
sequence-parallel ring needs send/receive and all-to-all, so on one card it
is checked as a composition in one process (`ring_composition`); the
NCCL phase (`nccl_phases`) runs tp and the teacher with `sp_mesh` on a card
a rank where there are two or more cards.

Every function returns a dict for chip_smoke.py to print and check; the
rank functions (`*_rank`) run in the spawned processes. Each rank's
comparison is against the same computation in one process, which the
caller runs before it spawns the ranks, from the same seeds.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from realtime_video_tpu_torch.config import WAN_CONFIGS
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion, generator_noise
from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm
from realtime_video_tpu_torch.parallel import collectives as coll
from realtime_video_tpu_torch.parallel import mesh as mesh_mod
from realtime_video_tpu_torch.parallel import sequence, sharding
from realtime_video_tpu_torch.training import ema as ema_mod
from realtime_video_tpu_torch.training import train_step as tstep
from realtime_video_tpu_torch.training.draws import TorchDraws
from realtime_video_tpu_torch.training.losses import tree_leaves

#: latents of one 832x480 frame: 60 x 104, 1560 tokens
LAT_H, LAT_W, FSL = 60, 104, 1560
BLOCK = 3 * FSL
#: 3 KV-cache frames + the 3 of the block (the server's kv_cache_num_frames 3)
CACHE = 2 * BLOCK
STEPS = (1000.0, 750.0, 500.0, 250.0)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()))


def rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest elementwise difference in bf16 ulps of `want`."""
    _, exp = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), exp - 8).clamp_min(2.0 ** -126)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def bound_ms(bytes_moved: float, ops: float, kind: str, more_ops=()):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind] + sum(o / PEAK_OPS[k] for o, k in more_ops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def reset_counts() -> None:
    hk.reset_launch_counts()
    hm.reset_launch_counts()


def read_counts() -> Dict[str, int]:
    return {"K1_window": hk.LAUNCHES["window"], "K2_block_causal": hk.LAUNCHES["block_causal"],
            "K2_int8_window": hk.LAUNCHES["window_int8qk"],
            "K2_int8_block_causal": hk.LAUNCHES["block_causal_int8qk"],
            "K3_int8_linear": hm.LAUNCHES["int8_linear"],
            "logit_bound_prepass": hk.PREPASS_LAUNCHES["logit_bound"],
            "window_bwd": hk.LAUNCHES["window_bwd"],
            "block_causal_bwd": hk.LAUNCHES["block_causal_bwd"],
            "plain_on_cuda": sum(hk.PLAIN_ON_CUDA.values()) + sum(hm.PLAIN_ON_CUDA.values())}


def model_params(name: str, layers: Optional[int], device, seed: int = 0):
    """(cfg, bf16 tree with fused qkv): `name`'s widths, `layers` deep (all
    of them for None), random from `seed`, with a random head (the init's
    is zero, which would make every flow 0)."""
    cfg = WAN_CONFIGS[name]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = wan_dit.init_wan_params(cfg, torch.Generator(device).manual_seed(seed), device)
    w = params["head"]["head"]["w"]
    params["head"]["head"]["w"] = (torch.randn(
        w.shape, generator=torch.Generator(device).manual_seed(seed + 100), device=device,
        dtype=torch.float32) * 0.02).to(w.dtype)
    return cfg, wan_dit.fuse_qkv_params(params)


def _gloo_on_card() -> dict:
    """The backend, and under gloo whether it all-reduces CUDA tensors."""
    if dist.get_backend() != "gloo":
        return {"backend": dist.get_backend()}
    ok, err = coll.gloo_takes_cuda()
    return {"backend": "gloo", "gloo_takes_cuda_all_reduce": ok, "gloo_error": err or None}


# ---------------------------------------------------------------------------
# tp: the serving denoise block at t2v-1.3B
# ---------------------------------------------------------------------------


def denoise_block(gen: WanDiffusion, device, seed: int = 1) -> dict:
    """Reset, prefill the previous block's clean latents, then denoise the
    next block in 4 steps (the server's block at 832x480, 3 KV frames):
    x0, the launch counts of the prefill and the steps, and the wall ms."""
    cfg = gen.cfg
    g = torch.Generator(device).manual_seed(seed)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=device)
    clean = torch.randn((1, 3, cfg.in_dim, LAT_H, LAT_W), generator=g, device=device)
    noisy = torch.randn((1, 3, cfg.in_dim, LAT_H, LAT_W), generator=g, device=device)
    cross = gen.compute_crossattn_cache(ctx.to(gen.dtype))
    kv = gen.init_kv_cache(1, CACHE, gen.dtype)
    fn = gen.make_denoise_block_fn(STEPS, CACHE)
    torch.cuda.synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        wan_dit.context_prefill(cfg, gen.params, clean.to(gen.dtype), gen.rope, cross, kv,
                                BLOCK, layers=gen.layers, mesh=gen.mesh)
        x0, kv = fn(kv, cross, noisy.to(gen.dtype), BLOCK,
                    generator_noise(torch.Generator(device).manual_seed(seed + 1)))
    torch.cuda.synchronize(device)
    return {"x0": x0.float().cpu(), "launches": read_counts(),
            "wall_ms": (time.perf_counter() - t0) * 1e3}


def expected_block_launches(layers: int, int8: bool) -> dict:
    """Launches of `denoise_block` on one rank: the prefill runs K2
    (self, block-causal) and K1 (cross) a layer; each of the 4 steps two K1
    a layer (self over the window, cross); every K1 one bound pre-pass;
    int8: 6 block linears (qkv, o, cross q, cross o, fc1, fc2) a layer a
    forward, the cross K/V dequantised once per prompt (no K3)."""
    forwards = 1 + len(STEPS)
    k1 = layers * (1 + 2 * len(STEPS))
    return {"K1_window": k1, "K2_block_causal": layers, "logit_bound_prepass": k1,
            "K3_int8_linear": 6 * layers * forwards if int8 else 0}


def _tier_params(tier: str, name: str, layers, device, act_scales):
    cfg, params = model_params(name, layers, device)
    if tier == "int8_static":
        params = wan_dit.quantize_wan_linears(params, act_scales={
            k: v for k, v in act_scales.items()})
    elif tier == "int8_dynamic":
        params = wan_dit.quantize_wan_linears(params)
    return cfg, params


def tp_denoise_rank(rank: int, world: int, spec: dict) -> dict:
    """The denoise block at tp = world, one tier after another, on this
    rank's slice of the same trees the one-process run used."""
    device = mesh_mod.rank_device("cuda")
    mesh = mesh_mod.make_mesh({"dp": 1, "tp": world}, "cuda")
    out = {"rank": rank, "device": torch.cuda.get_device_name(device), **_gloo_on_card()}
    for tier in spec["tiers"]:
        cfg, params = _tier_params(tier, spec["model"], None, device, spec["act_scales"])
        gen = WanDiffusion(cfg=cfg, params=params, mesh=mesh)
        del params
        torch.cuda.empty_cache()
        res = denoise_block(gen, device)
        res["heads_per_rank"] = gen.num_heads
        res["x0_sha256"] = hashlib.sha256(res["x0"].numpy().tobytes()).hexdigest()
        out[tier] = res
        del gen
        torch.cuda.empty_cache()
    return out


def calibrate(name: str, device) -> dict:
    """Static activation scales of `name` on one device (the serving
    loader's calibration), as CPU tensors for the ranks."""
    cfg, params = model_params(name, None, device)
    gen = WanDiffusion(cfg=cfg, params=params)
    scales = gen.calibrate_act_scales(STEPS)
    return {k: v.cpu() for k, v in scales.items()}


def one_process_block(tier: str, name: str, device, act_scales) -> dict:
    cfg, params = _tier_params(tier, name, None, device, act_scales)
    gen = WanDiffusion(cfg=cfg, params=params)
    res = denoise_block(gen, device)
    del gen, params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# tp: t2v-14B int8 with INT8_QK, 2 layers, tp 4
# ---------------------------------------------------------------------------


def forward_14b(gen: WanDiffusion, device, seed: int = 3) -> dict:
    """One decode forward of a block into a fresh cache (INT8_QK on)."""
    cfg = gen.cfg
    g = torch.Generator(device).manual_seed(seed)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=device)
    noisy = torch.randn((1, 3, cfg.in_dim, LAT_H, LAT_W), generator=g, device=device)
    t = torch.full((1, 3), 750.0, device=device)
    cross = gen.compute_crossattn_cache(ctx.to(gen.dtype))
    kv = gen.init_kv_cache(1, CACHE, gen.dtype)
    torch.cuda.synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, x0, _ = gen.forward(noisy.to(gen.dtype), cross, t, kv, 0, "decode", CACHE)
    torch.cuda.synchronize(device)
    return {"x0": x0.float().cpu(), "launches": read_counts(),
            "wall_ms": (time.perf_counter() - t0) * 1e3}


def _k3_case(x, p, device) -> dict:
    """K3 on this rank's weights against its plain version: bf16 ulps, the
    kernel's and the plain version's times, the bound."""
    w_q, w_scale = p["w_q"], p["scale"]
    a_scale = hm.dynamic_scale(x)
    kern = lambda: hm.int8_linear(x, w_q, w_scale, a_scale)  # noqa: E731
    plain = lambda: hm.int8_linear_plain(x, w_q, w_scale, a_scale)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize(device)
    m, (k, n) = x.numel() // x.shape[-1], w_q.shape
    b_ms, b_by = bound_ms(hm.int8_linear_bytes(m, k, n, bias=False),
                          hm.int8_linear_ops(m, k, n), "int8")
    return {"shape": [m, k, n], "max_err_bf16_ulps": bf16_ulps(got, want),
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "ms": event_ms(kern, 20), "plain_ms": event_ms(plain, 3), "bound_ms": b_ms,
            "bound_by": b_by, "w_q_strides": list(w_q.stride())}


def _attention_case(heads: int, device) -> dict:
    """K2-int8 (INT8_QK's window) at this rank's heads: the self-attention
    of a block over the 6-frame cache, beside its plain version and bound."""
    g = torch.Generator(device).manual_seed(11)
    q = torch.randn((1, BLOCK, heads, 128), generator=g, device=device).to(torch.bfloat16)
    k = torch.randn((1, CACHE, heads, 128), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((1, CACHE, heads, 128), generator=g, device=device).to(torch.bfloat16)
    route = "window_int8qk"
    kern = lambda: hk.window_attention(q, k, v, 0, CACHE, route=route)  # noqa: E731
    got = kern()
    want = hk.window_attention_int8qk_plain(q[:, :1024], k, v, 0, CACHE)
    agree = hk.agreement(got[:, :1024], want)
    flops = hk.window_flops(BLOCK, 0, CACHE, heads, 128)
    b_ms, b_by = bound_ms(2 * (q.numel() * 2 + k.numel() + v.numel()), flops / 2, "int8",
                          more_ops=((flops / 2, "bf16"),))
    return {"shape": [BLOCK, CACHE, heads, 128], "route": route,
            "max_abs_err_rows_1024": agree["max_abs_err"], "within_tol": agree["within_tol"],
            "ms": event_ms(kern, 10), "bound_ms": b_ms, "bound_by": b_by}


def tp_forward_14b_rank(rank: int, world: int, spec: dict) -> dict:
    device = mesh_mod.rank_device("cuda")
    mesh = mesh_mod.make_mesh({"dp": 1, "tp": world}, "cuda")
    out = {"rank": rank, **_gloo_on_card()}
    hk.INT8_QK = True
    cfg, params = _tier_params("int8_dynamic", "t2v-14B", spec["layers"], device, None)
    gen = WanDiffusion(cfg=cfg, params=params, mesh=mesh)
    del params
    torch.cuda.empty_cache()
    out.update(forward_14b(gen, device))
    shard = gen.params
    g = torch.Generator(device).manual_seed(5 + rank)
    cases = {"qkv": (cfg.dim, shard["blocks"]["self_attn"]["qkv"]),
             "fc2": (cfg.ffn_dim // world, shard["blocks"]["ffn"]["fc2"])}
    timings = {}
    for r in range(world):  # one rank times at a time: the ranks share the card
        dist.barrier()
        if r == rank:
            for name, (kdim, p) in cases.items():
                x = torch.randn((1, BLOCK, kdim), generator=g, device=device).to(torch.bfloat16)
                timings[name] = _k3_case(x, {"w_q": p["w_q"][0], "scale": p["scale"][0]}, device)
            timings["attention_int8qk"] = _attention_case(cfg.num_heads // world, device)
        torch.cuda.synchronize(device)
    dist.barrier()
    out["kernels"] = timings
    out["x0_sha256"] = hashlib.sha256(out["x0"].numpy().tobytes()).hexdigest()
    return out


def one_process_14b(layers: int, device) -> dict:
    prev = hk.INT8_QK
    hk.INT8_QK = True
    try:
        cfg, params = _tier_params("int8_dynamic", "t2v-14B", layers, device, None)
        res = forward_14b(WanDiffusion(cfg=cfg, params=params), device)
    finally:
        hk.INT8_QK = prev
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# dp x tp: one flow-matching step at t2v-1.3B width, 2 layers
# ---------------------------------------------------------------------------


TRAIN_LAYERS, TRAIN_FRAMES, TRAIN_BATCH, TRAIN_LR = 2, 6, 2, 1e-4


def _train_inputs(cfg, device):
    g = torch.Generator(device).manual_seed(21)
    lat = torch.randn((TRAIN_BATCH, TRAIN_FRAMES, cfg.in_dim, LAT_H, LAT_W), generator=g,
                      device=device).to(torch.bfloat16)
    emb = torch.randn((TRAIN_BATCH, cfg.text_len, cfg.text_dim), generator=g,
                      device=device).to(torch.bfloat16)
    return lat, emb


#: the parts of a step held against the one-process step
TRAIN_PARTS = ("grads", "update", "ema_step")


def train_step_run(mesh, device) -> dict:
    """One flow-matching step with the EMA on the mesh (None: one process on
    the whole batch): the gradients, the update, the EMA shadow's step (the
    shadow less the params it started from), the launches."""
    cfg, whole = model_params("t2v-1.3B", TRAIN_LAYERS, device)
    gen = WanDiffusion(cfg=cfg, params=whole)
    params, opt = tstep.make_train_state(gen, mesh, learning_rate=TRAIN_LR)
    before = {k: v.detach().clone() for k, v in tree_leaves(params).items()}
    shadow = ema_mod.init_ema(params)
    step = tstep.make_train_step(gen, opt, mesh, ema_decay=0.99)
    lat, emb = _train_inputs(cfg, device)
    torch.cuda.synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    metrics = step(params, lat, emb, TorchDraws(31, device), ema=shadow)
    torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    leaves = tree_leaves(params)
    return {"grads": {k: v.grad.detach() for k, v in leaves.items()},
            "update": {k: (v.detach().float() - before[k].float()) for k, v in leaves.items()},
            "ema_step": {k: v - before[k].float() for k, v in tree_leaves(shadow).items()},
            "params": {k: v.detach() for k, v in leaves.items()},
            "loss": metrics["loss"].item(), "launches": read_counts(), "wall_ms": wall_ms,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}


def _spec_leaves(specs: dict, prefix: str = "") -> dict:
    """{"a/b": spec} of a spec tree (specs are tuples, not tensors)."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_spec_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flat_cat(tree: dict) -> torch.Tensor:
    return torch.cat([t.float().flatten() for t in tree.values()])


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def dp_tp_train_rank(rank: int, world: int, spec: dict) -> dict:
    device = mesh_mod.rank_device("cuda")
    mesh = mesh_mod.make_mesh({"dp": 2, "tp": world // 2}, "cuda")
    out = {"rank": rank, "dp_rank": mesh_mod.axis_rank(mesh, "dp"),
           "tp_rank": mesh_mod.axis_rank(mesh, "tp"), **_gloo_on_card()}
    res = train_step_run(mesh, device)
    ref = torch.load(spec["reference"], map_location=device, weights_only=True)
    tp, tp_rank = mesh_mod.axis_size(mesh, "tp"), out["tp_rank"]
    specs = sharding.wan_param_pspecs(_nest(ref["params"]))
    want = {part: tree_leaves(sharding.shard_params(_nest(ref[part]), specs, tp, tp_rank))
            for part in TRAIN_PARTS}

    def held(run: dict, prefix: str = "") -> None:
        for part in TRAIN_PARTS:
            got = run[part]
            assert set(got) == set(want[part]), sorted(set(got) ^ set(want[part]))
            a, b = _flat_cat(got), _flat_cat({k: want[part][k] for k in got})
            out[f"{prefix}{part}_cosine"] = cosine(a, b)
            out[f"{prefix}{part}_rel_err"] = rel_fro(a, b)

    held(res)
    # planted fault: the dp average of the gradients dropped, so each dp rank
    # steps on its own rows' gradient
    reduce_mean = coll.all_reduce_mean_
    coll.all_reduce_mean_ = lambda tensors, group: None
    try:
        held(train_step_run(mesh, device), "fault_no_dp_mean_")
    finally:
        coll.all_reduce_mean_ = reduce_mean
    leaf_specs = _spec_leaves(specs)
    out["replicated_sha256"] = {
        k: hashlib.sha256(v.float().cpu().numpy().tobytes()).hexdigest()
        for k, v in res["params"].items() if "tp" not in leaf_specs[k]}
    out.update(loss=res["loss"], launches=res["launches"], wall_ms=res["wall_ms"],
               peak_gib=res["peak_gib"])
    return out


def one_process_train(device, path: str) -> dict:
    """The one-process step on the whole batch; its gradients, update, EMA
    step and params saved to `path` for the ranks."""
    res = train_step_run(None, device)
    torch.save({part: {k: v.cpu() for k, v in res[part].items()}
                for part in (*TRAIN_PARTS, "params")}, path)
    return {k: res[k] for k in ("loss", "launches", "wall_ms", "peak_gib")}


# ---------------------------------------------------------------------------
# sp: the ring's composition of K1 launches, one process
# ---------------------------------------------------------------------------


def ring_composition(device, length: int = 32760, heads_list=(12, 40), sps=(2, 4, 8)) -> list:
    """For rank 0's query shard of the teacher's unmasked self-attention, K1
    with its LSE over each key shard, merged (`sequence.merge_partial`),
    against one K1 launch with LSE over every key: the output within
    `hopper_attention.agreement`, the LSE within 2e-3; the per-shard
    launches and the merge timed beside the single launch and the bound."""
    rows = []
    for heads in heads_list:
        g = torch.Generator(device).manual_seed(heads)
        k = torch.randn((1, length, heads, 128), generator=g, device=device).to(torch.bfloat16)
        v = torch.randn((1, length, heads, 128), generator=g, device=device).to(torch.bfloat16)
        q_all = torch.randn((1, length, heads, 128), generator=g, device=device).to(
            torch.bfloat16)
        for sp in sps:
            share = length // sp
            q = q_all[:, :share].contiguous()
            shards = [(k[:, i * share:(i + 1) * share].contiguous(),
                       v[:, i * share:(i + 1) * share].contiguous()) for i in range(sp)]

            def ring():
                out = lse = None
                for ks, vs in shards:
                    o, lo = hk.window_attention(q, ks, vs, 0, share, route="window",
                                                return_lse=True)
                    out, lse = sequence.merge_partial(out, lse, o, lo)
                return out.to(q.dtype), lse

            def single():
                return hk.window_attention(q, k, v, 0, length, route="window", return_lse=True)

            hk.reset_launch_counts()
            got, got_lse = ring()
            launches = hk.LAUNCHES["window"]
            want, want_lse = single()
            agree = hk.agreement(got, want)
            lse_err = (got_lse - want_lse).abs().max().item()
            flops = hk.window_flops(share, 0, length, heads, 128)
            b_ms, b_by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel())
                                  + 4 * heads * share, flops, "bf16")
            ring_ms = event_ms(lambda: ring(), 5)
            launch_ms = event_ms(lambda: [hk.window_attention(q, ks, vs, 0, share,
                                                              route="window", return_lse=True)
                                          for ks, vs in shards], 5)
            rows.append({"heads": heads, "sp": sp, "lq": share, "lk_shard": share,
                         "launches": launches, "max_abs_err": agree["max_abs_err"],
                         "rel_fro_err": agree["rel_fro_err"], "within_tol": agree["within_tol"],
                         "lse_max_abs_err": lse_err, "lse_tol": 2e-3,
                         "ring_ms": ring_ms, "shard_launches_ms": launch_ms,
                         "merge_ms": ring_ms - launch_ms, "single_ms": event_ms(single, 5),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "partial_last_tile_rows": share % 128})
            del q, shards, got, want
        del k, v, q_all
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# NCCL, a card a rank
# ---------------------------------------------------------------------------


def teacher_sp_rank(rank: int, world: int, spec: dict) -> dict:
    """The 1.3B teacher's train-mode forward over 21 latents with sp_mesh's
    USP attention at sp = world, one card a rank."""
    from realtime_video_tpu_torch.pipelines.bidirectional_diffusion_inference import (
        BidirectionalDiffusionInferencePipeline,
    )

    device = mesh_mod.rank_device("cuda")
    mesh = mesh_mod.make_mesh({"sp": world}, "cuda")
    cfg, params = model_params("t2v-1.3B", None, device)
    gen = WanDiffusion(cfg=cfg, params=params)
    pipe = BidirectionalDiffusionInferencePipeline({}, gen, sp_mesh=mesh)
    mesh2 = pipe.usp_mesh
    flow = teacher_flow(gen, device, pipe.sp_attn)
    return {"rank": rank, "flow": flow.cpu(), "sp_r": mesh_mod.axis_size(mesh2, "sp_r"),
            "sp_u": mesh_mod.axis_size(mesh2, "sp_u")}


def teacher_flow(gen: WanDiffusion, device, sp_attn=None) -> torch.Tensor:
    cfg = gen.cfg
    g = torch.Generator(device).manual_seed(41)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g, device=device)
    x = torch.randn((1, 21, cfg.in_dim, LAT_H, LAT_W), generator=g, device=device)
    t = torch.full((1, 21), 900.0, device=device)
    with torch.no_grad():
        cross = gen.compute_crossattn_cache(ctx.to(gen.dtype))
        flow, _, _ = gen.forward(x.to(gen.dtype), cross, t, mode="train", sp_attn=sp_attn)
    return flow.float()
