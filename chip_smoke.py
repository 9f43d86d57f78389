"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 for the numbers in PERF.md).

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card's name and power limit (nvidia-smi), the build of the
     hand-written attention kernel from realtime_video_tpu_torch/csrc/;
  2. kernels against their plain PyTorch versions in bf16 at the serving
     shapes of t2v-1.3B at 832x480 (self-attention Lq 4680 / Lk 9360 with
     lo > 0, cross-attention Lk 512, block-causal 9360 tokens in 4680-token
     blocks, a large-norm input whose logit bound trips the running-max
     path), with each error against its bounds and both times, and planted
     faults in the window's edges that the same check must catch;
  3. a small DiT block step on the card against the same step on the CPU
     (plain versions), the port's own reference on a small input;
  4. the server: `load_all` builds t2v-1.3B (random weights from a seed) and
     the Wan 2.1 VAE in bf16 on the card, the aiohttp server listens on
     127.0.0.1, and two WebSocket sessions of 3 blocks each (832x480, 4
     steps, 3 KV-cache frames) must each return 30 finite JPEG frames and
     "completed" while the attention kernels' launch counters rise and no
     plain version sees a CUDA tensor.

Before its last line it prints the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without it, and so
does a host without a CUDA device. Kernel and plain times are CUDA-event
means; serving times are host-clock times at the WebSocket client.
"""
from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **kv) -> None:
    print(json.dumps({"phase": name, **kv}), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    import numpy as np
    from aiohttp import ClientSession, WSMsgType, web
    from msgpack import packb

    from realtime_video_tpu_torch.config import WanModelConfig, load_server_config
    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.models.rope import RopeTables
    from realtime_video_tpu_torch.ops import hopper_attention as hk
    from realtime_video_tpu_torch.ops import kv_cache as kvc
    from realtime_video_tpu_torch.serving import server as server_mod
    from realtime_video_tpu_torch.serving.models import load_all

    # comparisons below are in full f32 on the plain side: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: device and kernel build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = hk.build()
    build_s = time.perf_counter() - t0
    phase("device", card=card, kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, kernel_build_s=build_s, library=lib.name,
          tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
          tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # ---- phase 2: kernels against their plain versions ----
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def cuda_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    # The kernel receives q pre-scaled by scale*log2(e) in bf16; the plain
    # version is fed that same q (scale 1/log2 e), so the comparison holds the
    # kernel alone, under hk.agreement's bounds: elementwise atol +
    # hk.RTOL*|plain| (atol hk.ATOL, or hk.sharp_atol(v) for the sharp
    # softmax of the large-norm input) and relative Frobenius error hk.REL_FRO.
    inv = 1.0 / hk.LOG2E
    heads, hd = 12, 128
    tol = dict(rtol=hk.RTOL, rel_fro=hk.REL_FRO)
    results = {}
    cases = [
        ("self_attn", "window", 4680, 9360, 1560, 9360, 1.0),
        ("cross_attn", "window", 4680, 512, 0, 512, 1.0),
        ("large_norm", "window", 4680, 9360, 1560, 9360, 3.0),
        ("block_causal", "block_causal", 9360, 9360, 0, 4680, 1.0),
    ]
    for name, mode, lq, lk, lo, arg, scale in cases:
        q = hk.prescale(rnd((1, lq, heads, hd), scale), hd ** -0.5)
        k, v = rnd((1, lk, heads, hd), scale), rnd((1, lk, heads, hd))
        if mode == "window":
            m_bound = float(hk.logit_bound(q, k)[0])  # the bound the kernel tests
            kern = lambda: hk.window_attention(q, k, v, lo, arg, scale=inv)  # noqa: E731
            plain = lambda: hk.window_attention_plain(q, k, v, lo, arg, scale=inv)  # noqa: E731
            flop = hk.window_flops(lq, lo, arg, heads, hd)
            # planted faults, which the check must catch: the window starting
            # 8 columns late (inside the tile that straddles lo), and ending
            # 16 columns early (the ragged tail past the last full tile)
            faults = {"lo+8": lambda: hk.window_attention(q, k, v, lo + 8, arg, scale=inv),
                      "hi-16": lambda: hk.window_attention(q, k, v, lo, arg - 16, scale=inv)}
        else:
            m_bound = None
            kern = lambda: hk.block_causal_attention(q, k, v, arg, scale=inv)  # noqa: E731
            plain = lambda: hk.block_causal_attention_plain(q, k, v, arg, scale=inv)  # noqa: E731
            flop = hk.block_causal_flops(lq, arg, heads, hd)
            # planted fault: the last block stops 16 columns short of kv_len
            faults = {"kv_len-16": lambda: hk._launch(q, k, v, None, hk._MODE_BLOCK_CAUSAL,
                                                      0, lk, arg, lk - 16, -1)}
        got, want = kern(), plain()
        torch.cuda.synchronize()
        res = hk.agreement(got, want, hk.sharp_atol(v) if scale > 1 else hk.ATOL)
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
        results[name] = dict(**res, **tol, ms=ms, plain_ms=plain_ms, logit_bound=m_bound,
                             tflops_live=flop / ms / 1e9)
        phase("kernel", case=name, mode=mode, lq=lq, lk=lk, lo=lo, heads=heads, head_dim=hd,
              **results[name], card=card)
        if not res["within_tol"]:
            fail(f"{name}: kernel outside the bounds {tol} of the plain version: {res}")
        if name in ("self_attn", "block_causal"):
            for fault, fn in faults.items():
                bad = hk.agreement(fn(), want)
                phase("planted_fault", case=name, fault=fault, caught=not bad["within_tol"],
                      max_abs_err=bad["max_abs_err"], rel_fro_err=bad["rel_fro_err"])
                if bad["within_tol"]:
                    fail(f"{name}: the check passes the planted fault {fault}: {bad}")
        del q, k, v, got, want
    if results["large_norm"]["logit_bound"] < hk.STATIC_MAX_LIMIT:
        fail("the large-norm case does not reach the running-max path")
    if results["self_attn"]["logit_bound"] >= hk.STATIC_MAX_LIMIT:
        fail("the self-attention case does not take the static-max path")
    torch.cuda.empty_cache()

    # ---- phase 3: a small DiT block step on the card against the CPU ----
    small = WanModelConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2)
    cpu_gen = torch.Generator().manual_seed(1)
    p_cpu = wan_dit.fuse_qkv_params(wan_dit.init_wan_params(small, cpu_gen, "cpu",
                                                            torch.float32))
    p_cpu["head"]["head"]["w"] = torch.randn(p_cpu["head"]["head"]["w"].shape,
                                             generator=cpu_gen) * 0.05

    def to_gpu(node, path=()):
        """bf16 on the card, except what the model keeps in f32: the time MLP
        and the AdaLN modulation tables."""
        if isinstance(node, dict):
            return {k: to_gpu(v, path + (k,)) for k, v in node.items()}
        keep_f32 = path[0] in ("time_embedding", "time_projection") or path[-1] == "modulation"
        return node.to(dev, torch.float32 if keep_f32 else torch.bfloat16)

    p_gpu = to_gpu(p_cpu)
    ctx = torch.randn((1, 32, small.text_dim), generator=cpu_gen)
    lat = torch.randn((1, 6, 16, 16, 16), generator=cpu_gen)
    fsl = small.frame_seq_length(16, 16)
    outs = {}
    for name, params, device, dtype in (("cpu", p_cpu, "cpu", torch.float32),
                                        ("gpu", p_gpu, dev, torch.bfloat16)):
        rope = RopeTables.create(small.head_dim, device=device)
        cross = wan_dit.compute_crossattn_cache(small, params, ctx.to(device, dtype))
        kv = kvc.init_kv_cache(small.num_layers, 1, 6 * fsl, small.num_heads,
                               small.head_dim, dtype, device)
        wan_dit.context_prefill(small, params, lat[:, :3].to(device, dtype), rope, cross,
                                kv, block_tokens=3 * fsl)
        t = torch.full((1, 3), 937.5, device=device)
        flow, _ = wan_dit.dit_forward(small, params, lat[:, 3:].to(device, dtype), t, rope,
                                      cross, "decode", kv, 3 * fsl, 6 * fsl)
        outs[name] = flow.float().cpu()
    rel = ((outs["gpu"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()
    phase("dit_small_vs_cpu", rel_max_err=rel, tol=5e-2, shape=list(outs["gpu"].shape))
    if not (rel < 5e-2 and torch.isfinite(outs["gpu"]).all()):
        fail(f"small DiT block step on the card disagrees with the CPU: {rel}")

    # ---- phase 4: the server ----
    config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                timestep_shift=5.0)
    t0 = time.perf_counter()
    models = load_all(config, dev, seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    request = {"prompt": "a red fox running through snow", "width": 832, "height": 480,
               "seed": 7, "num_blocks": 3, "num_denoising_steps": 4,
               "kv_cache_num_frames": 3}
    # every frame the server encodes passes through here: record its shape,
    # whether it is finite, and its mean (the server maps [-1, 1] to [0, 1])
    encoded = []
    jpeg = server_mod._jpeg_bytes

    def checked_jpeg(frame, quality=90):
        encoded.append((frame.shape, bool(np.isfinite(frame).all()), float(frame.mean())))
        return jpeg(frame, quality)

    server_mod._jpeg_bytes = checked_jpeg

    async def drive():
        app = server_mod.create_app(config, models)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        sessions = []
        try:
            async with ClientSession() as client:
                for sid in ("smoke-0", "smoke-1"):
                    async with client.ws_connect(f"http://127.0.0.1:{port}/session/{sid}",
                                                 max_msg_size=0) as ws:
                        ready = await ws.receive_json(timeout=60)
                        if ready.get("status") != "ready":
                            fail(f"{sid}: no ready message: {ready}")
                        encoded.clear()
                        t_send = time.perf_counter()
                        await ws.send_bytes(packb(request))
                        stamps, sizes, final = [], [], None
                        while True:
                            msg = await ws.receive(timeout=600)
                            if msg.type == WSMsgType.BINARY:
                                stamps.append(time.perf_counter())
                                sizes.append(len(msg.data))
                            elif msg.type == WSMsgType.TEXT:
                                final = msg.json()
                                break
                            else:
                                fail(f"{sid}: socket closed before completion ({msg.type})")
                        sessions.append((sid, t_send, stamps, sizes, final,
                                         list(encoded)))
        finally:
            await runner.cleanup()
        return sessions

    hk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sessions = asyncio.run(drive())
    launches, plain_on_cuda = dict(hk.LAUNCHES), dict(hk.PLAIN_ON_CUDA)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    for sid, t_send, stamps, sizes, final, frames in sessions:
        if final != {"session_id": sid, "status": "completed"}:
            fail(f"{sid}: final message {final}")
        if len(stamps) != 30:
            fail(f"{sid}: {len(stamps)} frames, expected 30")
        if len(frames) != 30 or any(shape != (3, 480, 832) or not finite
                                    for shape, finite, _ in frames):
            fail(f"{sid}: encoded frames {[(s, f) for s, f, _ in frames]}")
        ends = [stamps[5], stamps[17], stamps[29]]  # blocks end at frames 6, 18, 30
        block_s = [ends[0] - t_send, ends[1] - ends[0], ends[2] - ends[1]]
        phase("session", session=sid, frames=len(stamps), jpeg_bytes_mean=float(np.mean(sizes)),
              ttff_ms=(stamps[0] - t_send) * 1e3, block_ms=[b * 1e3 for b in block_s],
              fps_warm=24 / (ends[2] - ends[0]), fps_session=30 / (ends[2] - t_send),
              pixel_mean=float(np.mean([m for _, _, m in frames])), card=card)
    phase("server", model="t2v-1.3B", tier="bf16", load_s=load_s, peak_mem_gib=peak_gb,
          launches=launches, plain_on_cuda=plain_on_cuda, card=card)
    if launches["window"] <= 0 or launches["block_causal"] <= 0:
        fail(f"a kernel of the path was not launched: {launches}")
    if any(plain_on_cuda.values()):
        fail(f"a plain version ran on a CUDA tensor in the serving path: {plain_on_cuda}")

    src = "realtime_video_tpu_torch/csrc/attention.cu"
    kernels = [
        {"name": "window_attention (K1 static-max; in-kernel running-max fallback)",
         "route": "cuda", "source": src,
         "replaces": "realtime_video_tpu/ops/pallas_attention.py:220",
         "launches": launches["window"],
         "max_abs_err": max(results["self_attn"]["max_abs_err"],
                            results["cross_attn"]["max_abs_err"]),
         "fallback_max_abs_err": results["large_norm"]["max_abs_err"],
         "ms": results["self_attn"]["ms"], "plain_ms": results["self_attn"]["plain_ms"]},
        {"name": "block_causal_attention (K2 running-max flash, block-causal mode)",
         "route": "cuda", "source": src,
         "replaces": "realtime_video_tpu/ops/pallas_attention.py:97",
         "launches": launches["block_causal"],
         "max_abs_err": results["block_causal"]["max_abs_err"],
         "ms": results["block_causal"]["ms"], "plain_ms": results["block_causal"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
