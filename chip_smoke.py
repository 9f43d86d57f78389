"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 for the numbers in PERF.md).

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card's name and power limit (nvidia-smi), the build of the
     three hand-written kernel libraries from realtime_video_tpu_torch/csrc/
     (one nvcc per source, all started together; with the earlier kernels'
     sources under _archive/, those too, for the A/B times below), and, per
     library, its counts of HGMMA / IGMMA (wgmma) and UTMALDG (TMA load)
     instructions in `cuobjdump -sass`: every library must show them;
  2. kernels against their plain PyTorch versions at serving shapes, with each
     error against its bound, the kernel's, the plain version's and a library
     call's CUDA-event time, and the least time the card could take
     (bound_ms), and planted faults that the same checks must catch; with
     _archive/ present, each redesigned kernel is timed beside the version
     it replaced in the same turns (earlier, new, new, earlier:
     `earlier_ms`):
       - attention in bf16 (csrc/attention_sm90.cu: wgmma, TMA, warp
         specialisation), t2v-1.3B shapes (K1/K2): self-attention Lq 4680 /
         Lk 9360 with lo > 0, cross-attention Lk 512, a large-norm input whose
         logit bound trips the running-max path, block-causal 9360 tokens in
         4680-token blocks, and the offline sampler's global window (Lk
         32760, live [0, 18720) and [0, 32760)); each timed as the route
         (the bound pre-pass, then the kernel) and as the kernel alone; the
         bound pre-pass's M against `logit_bound`'s (relative 1e-5); planted
         faults: the window's edges, the last block's end, and ring stages
         filled with the previous tile; and the teacher's self-attention,
         Lq = Lk = 32760 unmasked (256 q-tiles, the last of 120 rows) at 12
         and 40 heads, held on rows [0, 1024) and [31744, 32760) with every
         head and the whole K/V, timed beside SDPA flash on the same q, k, v,
         with a stale ring stage and the last 128 columns dropped as faults;
       - the same kernel's int8 QK^T mode (K2-int8) at t2v-14B shapes (40
         heads): self-attention Lq 4680 / Lk 9360 over [1560, 9360),
         cross-attention Lk 512, block-causal 4680 in one block, and keys that
         share an offset, on which one mean over the whole sequence, the last
         segment's k scales one row off and a ring stage out of step must be
         caught; its pre-pass (raw q, the prescale folded in) must give the
         plain version's s8 quanta but for a share <= 1e-3, off by 1 at most;
         the bf16 route at the same 14B shape is timed beside it; and at the
         14B teacher's shape, Lq = Lk = 32760 unmasked with 40 heads, held
         on the same two row ranges as K1's teacher case, timed beside the
         bf16 route and SDPA flash, with a stale ring stage and the last 128
         columns dropped as faults;
       - the skewed routes (K6a running max, K6b static max with the M >= 64
         fallback, also on a large-norm input), now launches of the same
         kernel, at the 1.3B self-attention shape, where a ring stage out of
         step must be caught;
       - the fused int8 linear (csrc/int8_mm.cu, K3: s8 wgmma, TMA) at the
         DiT block linears of t2v-1.3B (qkv, fc1, fc2 with K 8960, and o with
         a scale computed on the device) and of t2v-14B (qkv 4680 x 5120 x
         15360, fc2 4680 x 13824 x 5120; and the teacher's M = 32760 for qkv,
         fc2 and o with the device scale), on K-major weights, within 1 bf16
         ulp of the plain version; planted faults: the last K tile, w_scale a
         column off, a ring stage holding the previous K tile;
       - the kt x 3 x 3 conv (csrc/conv_sm90.cu, K4/K5: s8 wgmma, TMA, halos
         by TMA's zero fill) at VAE shapes: s8 with kt 3 at C 384 (60x104) and
         C 96 (480x832), the decoder's head (C 96 -> 3) and first conv (C 16
         -> 384), kt 1 with C 96 and C 3, stride 2; the int32 sums must equal
         the plain version's and the fused dequantise epilogue must equal the
         torch dequantise of those sums bit for bit; each also as the int8
         VAE's route (the quantise pre-pass, then the fused conv, from bf16),
         beside cuDNN's bf16 F.conv3d at the same shape (a different function,
         labelled so); bf16 kt 3 with bias under the attention kernel's
         agreement bound against cuDNN; planted faults: a halo row, the last
         32 bytes of channels, a ring stage out of step, tap dx = 2 reading
         tap dx = 1's rows of the shared A stage;
       - the convolutions the int8 VAE encoder launches for a webcam block at
         480x832 (9 frames fresh, then 12 streamed through its cache), each
         distinct form (kt, C, Co, stride, padding, T, H, W) recorded from
         the launches and held like the forms above (int32 sums equal, fused
         dequantise bit-equal) where phase 2 does not hold it already; the
         encode's CUDA-event time per block;
       - the int8 quantisers on the card against the CPU: one t2v-1.3B DiT
         layer and the whole Wan 2.1 VAE at full width, quantised from the same
         f32 weights on both, whose `scale`, `w_q` and `a_scale` must be equal
         bit for bit (and how many weight scales a Python-scalar divisor would
         have changed on the card);
       - umT5-xxl at full width (dim 4096, vocab 256384): a 2-layer slice on
         the card in bf16 against the CPU's f32 forward of the same weights
         (cosine > 0.999 over the prompt's tokens);
       - TAEHV's decode (cuDNN convs) on the card against the CPU's f32 on
         the same random init, 3 latents of 30x52: f32 with TF32 off within
         relative Frobenius 1e-3, bf16 within 3e-2; then one 832x480 block (3
         latents -> 12 frames) in bf16 with its carried state, timed beside
         its bound;
  3. a small DiT block step on the card against the same step on the CPU
     (plain versions), the port's own reference on a small input; the
     teacher's train-mode forward (no cache, no mask) at t2v-1.3B's full
     width with 2 layers on 3 latent frames at 832x480 the same way;
  4. the server: `load_all` builds a DiT (random weights from a seed) and the
     Wan 2.1 VAE on the card, and the aiohttp server listens on 127.0.0.1;
     every WebSocket session (3 blocks, 832x480, 4 steps, 3 KV-cache frames)
     must return its finite JPEG frames (30 for 3 blocks; 18 when a start
     frame, resume latents or a clip take one block of the budget) and
     "completed"; the launch counters, set to 0 just before a set of sessions
     and read just after, must show every kernel of that path, and no plain
     version may see a CUDA tensor. The text encoder is the static embedding
     (USE_STATIC_ENCODER_COND_DICT) unless a set says umT5:
       - t2v-1.3B in bf16, two sessions; then, on the same models, one
         session with RTV_ATTN_SKEW2's switch (K6b) and one with
         RTV_ATTN_SKEW's (K6a), whose block-0 x0 must match the default
         attention's (cosine > 0.999); then the teacher path on the same
         models (the teacher's precision, a random head, prompts from
         SeededTextEncoder) over a whole 81-frame clip, 21 latents of
         32760 tokens: `WanT2V.generate` (4 UniPC steps, guidance 5), the
         few-step `BidirectionalInferencePipeline` (the default step list,
         5 forwards) and `CausalDiffusionInferencePipeline` (7 blocks of 3,
         2 UniPC steps, two 32760-token caches), each decoded to 81 frames,
         its forwards timed apart with CUDA events, and K1 (with its bound
         pre-pass) launched exactly 2 x 30 times a forward;
       - t2v-1.3B in the int8 tier (`enable_int8`, `enable_int8_dit`,
         `int8_static_scales`: calibrated and quantised on the card), two
         sessions; block 0's x0 must correlate with the bf16 tier's (> 0.99)
         on the same seed and request, with a random head so that the DiT's
         output is not zero;
       - the same tier served by `load_all`'s default text encoder, umT5-xxl
         (random weights from the seed, the fallback tokenizer): its forward
         at L=512 timed with CUDA events beside its bound, the load and
         serving memory peaks, two sessions whose TTFF stands beside the
         static embedding's, one with a mid-stream prompt change (the encoder
         must run again); then on the same models: a webcam session whose
         client pushes seeded 640x480 JPEG frames at 24 fps (warm fps beside
         the push rate, the encode's CUDA-event ms per block, 6 + 12(n-1)
         frames; then the same three blocks driven without the server, each
         timed alone between syncs), a start-frame session (the image uploaded through
         /upload_start_frame and named by its path), a resume-latents session
         and, where cv2 can write a clip, an input-video session (the clip
         uploaded through /upload_video);
       - the checkpoint path: the random t2v-1.3B tree written as a
         reference-layout .pt state dict (the inverse mapping below), served in
         the int8 tier from `checkpoint_path`; its block-0 x0 must equal the
         random-init server's bit for bit;
       - the quantised-tree cache: `load_all` at 1.3B int8 with the TAEHV
         tier twice, RTV_QUANT_CACHE on in a temporary directory (a miss,
         then a hit): load seconds, entry sizes, the DiT and VAE trees equal
         bit for bit and stride for stride, block 0's x0 equal;
       - on the hit's models: the TAEHV preview tier (`use_taehv`), two
         sessions of 9 + 12 + 12 frames, TAEHV's decode timed per block;
         the offline sampler (`CausalInferencePipeline.inference` on a fresh
         pipeline: 21 latents over the global 32760-token window, 4 warped
         steps and the refresh forward a block, decoded to 81 frames), run
         twice with one seed (relative Frobenius < 1e-3), an extension from
         its first 3 latents (passed through unchanged) and an
         `encode_to_latent` of its first 9 frames; `sample_videos` (one
         prompt, 30 frames, an mp4 or .npy file);
       - t2v-14B in the int8 tier with the int8 QK^T attention on
         (RTV_ATTN_INT8's switch), one session, with its load peak and
         serving peak beside the memory plan's total, then one TAEHV session
         on the same models; block 0's x0 with the int8 QK^T attention on
         against off, on the same model (> 0.99); one teacher step with CFG
         (two train-mode forwards over the 21 latents) with the int8 QK^T
         attention, then with K1 in bf16 (`teacher_14b`): the two routes'
         latents and conditional flows at cosine > 0.99.
The quantised-tree cache is off (RTV_QUANT_CACHE=0) outside its phase, and
its directory is a temporary one, removed at exit.

Before its last line it prints the kernels' JSON summary, one row per TPU
kernel of the repo (nine rows, each with `earlier_ms`: the replaced
version's time in this run where _archive/ holds it, else null); the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without it, and so does a host without a CUDA device.
Phase 1 also names the JPEG codec the server uses (the native libjpeg codec,
built with g++ from native/frame_codec.cpp, or PIL).
Every phase line carries t_s, the seconds since the start; a run that
outlasts WATCHDOG_S dumps every thread's Python stack to stderr and exits 1.
Kernel, plain and library times are CUDA-event means; serving times are
host-clock times at the WebSocket client. bound_ms is the larger of the
bytes a call must move over 3.35 TB/s and its operations over the dense
peak of their type (989 TFLOP/s bf16, 1979 TOP/s int8; the int8 QK^T mode's
QK^T counts as int8, its PV as bf16), the H100 SXM data-sheet figures at
700 W.
"""
from __future__ import annotations

import asyncio
import atexit
import ctypes
import dataclasses
import faulthandler
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
#: a stalled run ends here, inside the 1200 s a run may take, with a stack dump
WATCHDOG_S = 1100
_T0 = time.perf_counter()
#: the replaced versions' sources, kept out of git for A/B runs: the
#: previous bf16 wgmma attention, the mma.sync int8 QK^T / skew attention,
#: the mma.sync conv (with the sm90.cuh they were built with beside them)
ARCHIVE = Path(__file__).resolve().parent / "_archive"
EARLIER_SOURCES = (ARCHIVE / "attention_sm90_earlier.cu", ARCHIVE / "attention_mma_earlier.cu",
                   ARCHIVE / "conv3x3_earlier.cu")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **kv) -> None:
    print(json.dumps({"phase": name, "t_s": time.perf_counter() - _T0, **kv}), flush=True)


def bound(bytes_moved: float, ops: float, kind: str, more_ops=()):
    """(bound_ms, bound_by): the least time the card could take; more_ops adds
    (operations, kind) pairs of other types to the operations' time."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind] + sum(o / PEAK_OPS[k] for o, k in more_ops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sass_counts(lib: Path, nvcc: str) -> dict:
    """Counts of wgmma (HGMMA bf16, IGMMA s8) and TMA load (UTMALDG)
    instructions in a library's SASS."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "IGMMA", "UTMALDG")}


def load_earlier(libs: dict):
    """The replaced versions' libraries, bound as their sources declare them, or None
    without _archive/: (bf16 wgmma attention, mma.sync attention, conv)."""
    if not all(src in libs for src in EARLIER_SOURCES):
        return None
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    sm90 = ctypes.CDLL(str(libs[EARLIER_SOURCES[0]]))
    sm90.rtv_attention_sm90.argtypes = [p] * 4 + [i] * 5 + [f, p] + [i] * 7 + [p]
    sm90.rtv_attention_sm90.restype = i
    sm90.rtv_logit_bound.argtypes = [p] * 3 + [ll, ll, i, f, p]
    sm90.rtv_logit_bound.restype = i
    att = ctypes.CDLL(str(libs[EARLIER_SOURCES[1]]))
    att.rtv_attention.argtypes = [p] * 6 + [i] * 5 + [p] + [i] * 10 + [p]
    att.rtv_attention.restype = i
    att.rtv_int8_qk_quantize.argtypes = [p] * 7 + [i] * 6 + [p]
    att.rtv_int8_qk_quantize.restype = i
    conv = ctypes.CDLL(str(libs[EARLIER_SOURCES[2]]))
    conv.rtv_conv3x3.argtypes = [p] * 3 + [i, p] + [i] * 14 + [p]
    conv.rtv_conv3x3.restype = i
    return sm90, att, conv


def cosine(a, b) -> float:
    """Cosine similarity, in f32 whatever the inputs' dtype."""
    a, b = a.flatten().float(), b.flatten().float()
    return float(a @ b / (a.norm() * b.norm()))


def reference_state_dict(params, cfg) -> dict:
    """The port's t2v DiT tree as a reference-layout state dict on the CPU
    (causal_model.py's names, the self-attention q/k/v split as upstream
    checkpoints store them): the inverse of utils/checkpoint.convert_wan_dit."""
    sd = {}
    d = cfg.dim

    def put(name, t):
        sd[name] = t.detach().cpu().contiguous()

    def lin(name, p):
        put(f"{name}.weight", p["w"].t())
        if "b" in p:
            put(f"{name}.bias", p["b"])

    def layer(p, i):
        return {k: v[i] for k, v in p.items()}

    pt, ph, pw = cfg.patch_size
    pe = params["patch_embedding"]
    put("patch_embedding.weight", pe["w"].t().reshape(d, cfg.in_dim, pt, ph, pw))
    put("patch_embedding.bias", pe["b"])
    for name, group, key in (("text_embedding.0", "text_embedding", "fc1"),
                             ("text_embedding.2", "text_embedding", "fc2"),
                             ("time_embedding.0", "time_embedding", "fc1"),
                             ("time_embedding.2", "time_embedding", "fc2"),
                             ("time_projection.1", "time_projection", "fc")):
        lin(name, params[group][key])
    bp = params["blocks"]
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            a = bp[attn]
            if "qkv" in a:
                w, bias = a["qkv"]["w"][i], a["qkv"]["b"][i]
                for j, n in enumerate("qkv"):
                    lin(f"{b}.{attn}.{n}", {"w": w[:, j * d:(j + 1) * d],
                                            "b": bias[j * d:(j + 1) * d]})
            else:
                for n in "qkv":
                    lin(f"{b}.{attn}.{n}", layer(a[n], i))
            lin(f"{b}.{attn}.o", layer(a["o"], i))
            put(f"{b}.{attn}.norm_q.weight", a["norm_q"]["scale"][i])
            put(f"{b}.{attn}.norm_k.weight", a["norm_k"]["scale"][i])
        lin(f"{b}.ffn.0", layer(bp["ffn"]["fc1"], i))
        lin(f"{b}.ffn.2", layer(bp["ffn"]["fc2"], i))
        put(f"{b}.modulation", bp["modulation"][i])
        if "norm3" in bp:
            put(f"{b}.norm3.weight", bp["norm3"]["scale"][i])
            put(f"{b}.norm3.bias", bp["norm3"]["bias"][i])
    lin("head.head", params["head"]["head"])
    put("head.modulation", params["head"]["modulation"])
    return sd


def t5_work(cfg, length: int):
    """(bytes, operations) of one umT5 forward of `length` tokens: every
    weight and the tokens' embedding rows read once and the output written
    once, in bf16; the projections' and the attention's multiply-adds."""
    per_layer = 4 * cfg.dim * cfg.dim_attn + 3 * cfg.dim * cfg.dim_ffn
    ops = cfg.num_layers * (2.0 * length * per_layer + 4.0 * length * length * cfg.dim_attn)
    moved = 2.0 * (cfg.num_layers * (per_layer + 2 * cfg.dim) + 2 * length * cfg.dim)
    return moved, ops


def tensors(tree):
    """Every tensor of a nested dict / list tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tensors(v)
    else:
        yield tree


def int8_leaves(tree, path=""):
    """(path, tensor) of every w_q, scale and a_scale of an int8 tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "w_q" in tree and k in ("w_q", "scale", "a_scale"):
                yield f"{path}/{k}", v
            elif isinstance(v, (dict, list)):
                yield from int8_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from int8_leaves(v, f"{path}/{i}")


def tree_to(tree, device, dtype=None):
    """The tree's tensors on `device`, floating ones cast to `dtype` if given."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype) for v in tree]
    if tree is None:
        return None
    if dtype is not None and tree.is_floating_point():
        return tree.to(device, dtype)
    return tree.to(device)


def weight_amaxes(tree):
    """The per-output-channel max|w| of every quantisable weight in a float
    tree: the stacked DiT linears [L, in, out] per layer, the VAE's 3x3 convs
    [kt, 3, 3, ci, co] (or [3, 3, ci, co]) over all but co."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "w" and hasattr(v, "dim"):
                if v.dim() == 3:
                    yield v.abs().amax(dim=1)
                elif (v.dim() == 5 and v.shape[1] == 3) or (v.dim() == 4 and v.shape[0] == 3):
                    yield v.abs().reshape(-1, v.shape[-1]).amax(dim=0)
            else:
                yield from weight_amaxes(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from weight_amaxes(v)


def bits_differing(cpu_tree, gpu_tree) -> dict:
    """{path: elements whose bits differ} over the int8 leaves of two trees,
    every leaf listed; a leaf missing on one side counts as -1."""
    import torch

    cpu, gpu = dict(int8_leaves(cpu_tree)), dict(int8_leaves(gpu_tree))
    out = {}
    for path in sorted(set(cpu) | set(gpu)):
        if path not in cpu or path not in gpu or cpu[path].shape != gpu[path].shape:
            out[path] = -1
            continue
        a, b = cpu[path].contiguous(), gpu[path].cpu().contiguous()
        bits = torch.int8 if a.dtype == torch.int8 else torch.int32
        out[path] = int((a.view(bits) != b.view(bits)).sum())
    return out


def main() -> None:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    # the quantised-tree cache stays off but in the quant_cache phase; any
    # entry it writes goes to a temporary directory, removed at exit
    qcache_dir = tempfile.mkdtemp(prefix="rtv_qcache_")
    atexit.register(shutil.rmtree, qcache_dir, ignore_errors=True)
    os.environ["RTV_QUANT_CACHE_DIR"] = qcache_dir
    os.environ["RTV_QUANT_CACHE"] = "0"
    import numpy as np
    import torch.nn.functional as F
    from aiohttp import ClientSession, FormData, WSMsgType, web
    from msgpack import packb
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from realtime_video_tpu_torch import native
    from realtime_video_tpu_torch.config import (
        SAMPLE_NEG_PROMPT,
        T5_CONFIGS,
        VAE_CONFIGS,
        WAN_CONFIGS,
        WanModelConfig,
        load_server_config,
    )
    from realtime_video_tpu_torch import sample as sample_mod
    from realtime_video_tpu_torch.generators import WanT2V
    from realtime_video_tpu_torch.models import t5 as t5_mod
    from realtime_video_tpu_torch.models import taehv as taehv_mod
    from realtime_video_tpu_torch.models import vae as vae_mod
    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
    from realtime_video_tpu_torch.models.rope import RopeTables
    from realtime_video_tpu_torch.models.text_encoder import SeededTextEncoder, WanTextEncoder
    from realtime_video_tpu_torch.ops import cuda_build
    from realtime_video_tpu_torch.ops import hopper_attention as hk
    from realtime_video_tpu_torch.ops import hopper_conv as hc
    from realtime_video_tpu_torch.ops import hopper_int8_mm as hm
    from realtime_video_tpu_torch.ops import kv_cache as kvc
    from realtime_video_tpu_torch.parallel.plan import serving_memory_plan
    from realtime_video_tpu_torch.pipelines import (
        BidirectionalInferencePipeline,
        CausalDiffusionInferencePipeline,
        CausalInferencePipeline,
    )
    from realtime_video_tpu_torch.serving import server as server_mod
    from realtime_video_tpu_torch.serving import session as session_mod
    from realtime_video_tpu_torch.serving.models import load_all, load_taehv, load_vae
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession
    from realtime_video_tpu_torch.solvers import make_solver
    from realtime_video_tpu_torch.utils.tokenizer import FallbackTokenizer

    # comparisons below are in full f32 on the plain side: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernel_mods = (hk, hm, hc)

    def read_counts():
        launches = {k: v for m in kernel_mods for k, v in m.LAUNCHES.items()}
        launches.update(hk.PREPASS_LAUNCHES)
        launches.update(hc.PREPASS_LAUNCHES)
        return launches, {k: v for m in kernel_mods for k, v in m.PLAIN_ON_CUDA.items()}

    # ---- phase 1: device and kernel builds ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    sources = [*hk.SOURCES, hm.SOURCE, hc.SOURCE]
    archived = [src for src in EARLIER_SOURCES if src.exists()]
    t0 = time.perf_counter()
    libs = cuda_build.build_all(sources + archived)
    build_s = time.perf_counter() - t0
    earlier = load_earlier(libs)
    sass = {libs[src].name: sass_counts(libs[src], cuda_build.nvcc()) for src in sources}
    jpeg_codec = "native libjpeg (native/frame_codec.cpp)" if native.available() else "PIL"
    print(f"JPEG codec: {jpeg_codec}", flush=True)
    phase("device", card=card, kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, kernel_build_s=build_s, jpeg_codec=jpeg_codec,
          libraries=[libs[src].name for src in sources],
          archived_earlier_kernels=[src.name for src in archived], sass=sass,
          tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
          tf32_cudnn=torch.backends.cudnn.allow_tf32)
    for src, ops in ((hk.SM90_SOURCE, ("HGMMA", "IGMMA", "UTMALDG")),
                     (hm.SOURCE, ("IGMMA", "UTMALDG")),
                     (hc.SOURCE, ("HGMMA", "IGMMA", "UTMALDG"))):
        counts = sass[libs[src].name]
        if not all(counts[op] > 0 for op in ops):
            fail(f"{src.name}: no {ops} in its SASS: {counts}")

    # ---- phase 2: kernels against their plain versions ----
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def rint8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

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

    def ab_ms(new, old, n):
        """(new ms, earlier ms or None): with an earlier version, timed in
        turns earlier, new, new, earlier, each a mean over n launches."""
        if old is None:
            return cuda_ms(new, n), None
        t = [cuda_ms(old, n), cuda_ms(new, n), cuda_ms(new, n), cuda_ms(old, n)]
        return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check_err(err, what):
        if err:
            fail(f"{what} launch failed: cudaError {err}")

    def earlier_sm90(q, k, v, scale, maxima, mode, lo, hi, bt, kv_len):
        """The previous bf16 wgmma attention kernel on raw q."""
        out = torch.empty_like(q)
        b, lq, n, d = q.shape
        check_err(earlier[0].rtv_attention_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, k.shape[1], n, d,
            hk.qscale(scale), None if maxima is None else maxima.data_ptr(), mode, lo, hi, bt,
            kv_len, -1, 0, stream()), "the earlier attention kernel")
        return out

    def earlier_maxima(q, k, scale):
        maxima = torch.empty(2, dtype=torch.float32, device=dev)
        check_err(earlier[0].rtv_logit_bound(q.data_ptr(), k.data_ptr(), maxima.data_ptr(),
                                             q.numel() // 128, k.numel() // 128, 128,
                                             hk.qscale(scale), stream()),
                  "the earlier bound pre-pass")
        return maxima

    def earlier_mma(q, k, v, scale, mode, lo, hi, bt, kv_len, int8, static):
        """The mma.sync kernel as its routes ran it: a torch prescale, then
        the int8 pre-pass and the int8 mode, or the skewed loop (with the
        torch logit bound for the static max)."""
        qs = hk.prescale(q, scale)
        b, lq, n, d = q.shape
        lk = k.shape[1]
        out = torch.empty_like(q)
        if int8:
            seg = hk.segment_rows(lk)
            q8, k8 = torch.empty_like(q, dtype=torch.int8), torch.empty_like(k, dtype=torch.int8)
            sq = torch.empty((b, n, lq), dtype=torch.float32, device=dev)
            sk = torch.empty((b, n, lk), dtype=torch.float32, device=dev)
            km = torch.empty((b, -(-lk // seg), n, d), dtype=torch.float32, device=dev)
            check_err(earlier[1].rtv_int8_qk_quantize(
                qs.data_ptr(), k.data_ptr(), q8.data_ptr(), sq.data_ptr(), k8.data_ptr(),
                sk.data_ptr(), km.data_ptr(), b, lq, lk, n, d, seg, stream()),
                "the earlier int8 pre-pass")
            args = (q8, k8, v, out, sq.data_ptr(), sk.data_ptr(), None, 1, 0, seg)
        else:
            m_bound = hk.logit_bound(qs, k) if static else None
            args = (qs, k, v, out, None, None, None if m_bound is None else m_bound.data_ptr(),
                    0, 1, 0)
        a, kk, vv, oo, sqp, skp, mb, i8, skew, seg = args
        check_err(earlier[1].rtv_attention(
            a.data_ptr(), kk.data_ptr(), vv.data_ptr(), oo.data_ptr(), sqp, skp, b, lq, lk, n, d,
            mb, mode, lo, hi, bt, kv_len, -1, i8, skew, seg, 0, stream()),
            "the earlier mma.sync attention")
        return out

    def earlier_conv(x, w, stride, padding, bias=None):
        """The mma.sync conv on a contiguous x and the Co-contiguous w."""
        int8 = x.dtype == torch.int8
        out = torch.empty(hc.out_shape(x.shape, w.shape, stride, padding),
                          dtype=torch.int32 if int8 else x.dtype, device=dev)
        t, h, w_, c = x.shape
        (ph0, ph1), (pw0, pw1) = padding
        check_err(earlier[2].rtv_conv3x3(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            0 if bias is None else 1, out.data_ptr(), int(int8), t, h, w_, c, w.shape[-1],
            w.shape[0], stride[0], stride[1], ph0, ph1, pw0, pw1, 0, stream()),
            "the earlier conv")
        return out

    # -- attention (K1, K2) --
    # The plain version is fed the q the kernel multiplies by bf16(scale *
    # log2 e): here q is pre-scaled once and every side takes scale 1/log2 e
    # (a factor of exactly 1), so the comparison holds the kernel alone, under
    # hk.agreement's bounds: elementwise atol + hk.RTOL*|plain| (atol
    # hk.ATOL, or hk.sharp_atol(v) for the sharp softmax of the large-norm
    # input) and relative Frobenius error hk.REL_FRO. "ms" is the kernel
    # alone (the bound's maxima computed beforehand), "route_ms" the route as
    # the main path calls it (the bound pre-pass, then the kernel); SDPA's
    # time is its kernel alone.
    inv = 1.0 / hk.LOG2E
    heads, hd = 12, 128
    tol = dict(rtol=hk.RTOL, rel_fro=hk.REL_FRO)
    results = {}
    cases = [
        ("self_attn", "window", 4680, 9360, 1560, 9360, 1.0),
        ("cross_attn", "window", 4680, 512, 0, 512, 1.0),
        ("large_norm", "window", 4680, 9360, 1560, 9360, 3.0),
        ("block_causal", "block_causal", 9360, 9360, 0, 4680, 1.0),
        # the offline sampler's global window (21 frames): a block attends
        # over [0, 18720) at block 3 and [0, 32760) at block 6
        ("offline_window_18720", "window", 4680, 32760, 0, 18720, 1.0),
        ("offline_window_32760", "window", 4680, 32760, 0, 32760, 1.0),
    ]
    for name, mode, lq, lk, lo, arg, scale in cases:
        q = hk.prescale(rnd((1, lq, heads, hd), scale), hd ** -0.5)
        k, v = rnd((1, lk, heads, hd), scale), rnd((1, lk, heads, hd))
        qt = q.transpose(1, 2)
        if mode == "window":
            maxima = hk.logit_bound_maxima(q, k, inv)
            m_bound = float(hk.logit_bound_from_maxima(maxima)[0])  # the bound the kernel tests
            m_ref = float(hk.logit_bound(hk.prescale(q, inv), k)[0])
            if abs(m_bound - m_ref) > 1e-5 * m_ref:
                fail(f"{name}: the bound pre-pass's M {m_bound} is not logit_bound's {m_ref}")
            kern = lambda: hk.window_attention(q, k, v, lo, arg, scale=inv)  # noqa: E731
            alone = lambda: hk._launch_sm90(q, k, v, inv, maxima, hk._MODE_WINDOW,  # noqa: E731
                                            lo, arg, 1, lk, -1)
            if earlier is not None:
                e_route = lambda: earlier_sm90(  # noqa: E731
                    q, k, v, inv, earlier_maxima(q, k, inv), hk._MODE_WINDOW, lo, arg, 1, lk)
                e_alone = lambda: earlier_sm90(q, k, v, inv, maxima, hk._MODE_WINDOW,  # noqa: E731
                                               lo, arg, 1, lk)
            plain = lambda: hk.window_attention_plain(q, k, v, lo, arg, scale=inv)  # noqa: E731
            flop = hk.window_flops(lq, lo, arg, heads, hd)
            io_bytes = 2.0 * heads * hd * (2 * lq + 2 * (arg - lo))
            ks, vs = k[:, lo:arg].transpose(1, 2), v[:, lo:arg].transpose(1, 2)
            backend, lib_mask = "flash (window slice k[:, lo:hi])", None
            backends = [SDPBackend.FLASH_ATTENTION]
            # planted faults, which the check must catch: the window starting
            # 8 columns late (inside the tile that straddles lo), ending 16
            # columns early (the ragged tail past the last full tile), and the
            # last ring stages filled with the previous tile's rows
            faults = {"lo+8": lambda: hk.window_attention(q, k, v, lo + 8, arg, scale=inv),
                      "hi-16": lambda: hk.window_attention(q, k, v, lo, arg - 16, scale=inv),
                      "stale_ring_stage": lambda: hk._launch_sm90(
                          q, k, v, inv, maxima, hk._MODE_WINDOW, lo, arg, 1, lk, -1,
                          fault=hk.FAULT_STALE_RING_STAGE)}
        else:
            m_bound = m_ref = None
            kern = lambda: hk.block_causal_attention(q, k, v, arg, scale=inv)  # noqa: E731
            alone = kern
            if earlier is not None:
                e_route = e_alone = lambda: earlier_sm90(  # noqa: E731
                    q, k, v, inv, None, hk._MODE_BLOCK_CAUSAL, 0, lk, arg, lk)
            plain = lambda: hk.block_causal_attention_plain(q, k, v, arg, scale=inv)  # noqa: E731
            flop = hk.block_causal_flops(lq, arg, heads, hd)
            io_bytes = 2.0 * heads * hd * 4 * lq
            ks, vs = k.transpose(1, 2), v.transpose(1, 2)
            lib_mask = hk.block_causal_mask(lq, lk, arg, lk, None, dev)
            backend, backends = None, [SDPBackend.EFFICIENT_ATTENTION,
                                       SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
            # planted faults: the last block stops 16 columns short of kv_len;
            # the last ring stage holds the previous tile
            faults = {"kv_len-16": lambda: hk._launch_sm90(
                          q, k, v, inv, None, hk._MODE_BLOCK_CAUSAL, 0, lk, arg, lk - 16, -1),
                      "stale_ring_stage": lambda: hk._launch_sm90(
                          q, k, v, inv, None, hk._MODE_BLOCK_CAUSAL, 0, lk, arg, lk, -1,
                          fault=hk.FAULT_STALE_RING_STAGE)}
        got, want = kern(), plain()
        torch.cuda.synchronize()
        res = hk.agreement(got, want, hk.sharp_atol(v) if scale > 1 else hk.ATOL)
        if earlier is not None:
            res1 = hk.agreement(e_alone(), want, hk.sharp_atol(v) if scale > 1 else hk.ATOL)
            if not res1["within_tol"]:
                fail(f"{name}: the earlier kernel disagrees with the plain version: {res1}")
        ms, earlier_ms = ab_ms(alone, e_alone if earlier else None, 20)
        route_ms, earlier_route_ms = ab_ms(kern, e_route if earlier else None, 20)
        plain_ms = cuda_ms(plain, 3)
        library_ms = None
        for b in backends:  # the first backend that takes the masked call
            try:
                with sdpa_kernel([b]):
                    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                        qt, ks, vs, attn_mask=lib_mask, scale=inv), 10)
                backend = backend or f"{b.name} (boolean block mask)"
                break
            except RuntimeError:
                continue
        bound_ms, bound_by = bound(io_bytes, flop, "bf16")
        results[name] = dict(**res, **tol, ms=ms, route_ms=route_ms, earlier_ms=earlier_ms,
                             earlier_route_ms=earlier_route_ms, plain_ms=plain_ms,
                             library_ms=library_ms, library=f"torch SDPA {backend}",
                             bound_ms=bound_ms, bound_by=bound_by, logit_bound=m_bound,
                             logit_bound_reference=m_ref, tflops_live=flop / ms / 1e9)
        phase("kernel", kernel="attention", case=name, mode=mode, lq=lq, lk=lk, lo=lo,
              heads=heads, head_dim=hd, **results[name], card=card)
        if not res["within_tol"]:
            fail(f"{name}: kernel outside the bounds {tol} of the plain version: {res}")
        if name in ("self_attn", "block_causal"):
            for fault, fn in faults.items():
                bad = hk.agreement(fn(), want)
                phase("planted_fault", case=name, fault=fault, caught=not bad["within_tol"],
                      max_abs_err=bad["max_abs_err"], rel_fro_err=bad["rel_fro_err"])
                if bad["within_tol"]:
                    fail(f"{name}: the check passes the planted fault {fault}: {bad}")
        del q, k, v, got, want, qt, ks, vs, lib_mask
    if results["large_norm"]["logit_bound"] < hk.STATIC_MAX_LIMIT:
        fail("the large-norm case does not reach the running-max path")
    if results["self_attn"]["logit_bound"] >= hk.STATIC_MAX_LIMIT:
        fail("the self-attention case does not take the static-max path")
    torch.cuda.empty_cache()

    # -- K1 at the teacher's shape: train-mode self-attention over a whole
    # 81-frame clip, 32760 queries against 32760 keys, unmasked (256 q-tiles,
    # the last of 120 rows), at t2v-1.3B's 12 heads and t2v-14B's 40. A plain
    # version over every row would need 51.5 GB of f32 logits at 12 heads, so
    # the error is taken on rows [0, 1024) and [31744, 32760) (all heads, the
    # whole K/V); plain_ms is the plain version on the first range.
    teacher_k1 = {}
    tl = 32760
    row_ranges = ((0, 1024), (31744, tl))
    for name, nh in (("teacher_self_32760", 12), ("teacher_self_32760_14b", 40)):
        q = hk.prescale(rnd((1, tl, nh, hd)), hd ** -0.5)
        k, v = rnd((1, tl, nh, hd)), rnd((1, tl, nh, hd))
        maxima = hk.logit_bound_maxima(q, k, inv)
        kern = lambda: hk.window_attention(q, k, v, 0, tl, scale=inv)  # noqa: E731
        alone = lambda: hk._launch_sm90(q, k, v, inv, maxima, hk._MODE_WINDOW,  # noqa: E731
                                        0, tl, 1, tl, -1)

        def rows(out):
            return [out[:, a:b] for a, b in row_ranges]

        got = rows(kern())
        want = [hk.window_attention_plain(q[:, a:b], k, v, 0, tl, scale=inv)
                for a, b in row_ranges]
        torch.cuda.synchronize()
        res = hk.agreement(torch.cat(got, dim=1), torch.cat(want, dim=1))
        per_range = {f"rows_{a}_{b}": hk.agreement(g, w)["rel_fro_err"]
                     for (a, b), g, w in zip(row_ranges, got, want)}
        n_time = 5 if nh == 12 else 3
        ms, route_ms = cuda_ms(alone, n_time), cuda_ms(kern, n_time)
        plain_ms = cuda_ms(lambda: hk.window_attention_plain(q[:, :1024], k, v, 0, tl,
                                                             scale=inv), 2)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=inv),
                                 n_time)
        flop = hk.window_flops(tl, 0, tl, nh, hd)
        bound_ms, bound_by = bound(2.0 * nh * hd * 4 * tl, flop, "bf16")
        m_bound = float(hk.logit_bound_from_maxima(maxima)[0])
        teacher_k1[name] = dict(**res, **tol, rel_fro_by_rows=per_range, ms=ms,
                                route_ms=route_ms, plain_ms_rows_1024=plain_ms,
                                library_ms=library_ms, library="torch SDPA flash, unmasked",
                                bound_ms=bound_ms, bound_by=bound_by, logit_bound=m_bound,
                                tflops=flop / ms / 1e9)
        phase("kernel", kernel="attention", case=name, mode="window", lq=tl, lk=tl, lo=0,
              hi=tl, heads=nh, head_dim=hd, q_tiles=-(-tl // 128),
              last_tile_rows=tl - 128 * (tl // 128), checked_rows=row_ranges,
              **teacher_k1[name], card=card)
        if not res["within_tol"]:
            fail(f"{name}: kernel outside the bounds {tol} of the plain version: {res}")
        if m_bound >= hk.STATIC_MAX_LIMIT:
            fail(f"{name}: the teacher case does not take the static-max path")
        if nh == 12:
            # planted faults: the last ring stages filled with the previous
            # tile; the window's last 128 columns dropped
            faults = {"stale_ring_stage": lambda: hk._launch_sm90(
                          q, k, v, inv, maxima, hk._MODE_WINDOW, 0, tl, 1, tl, -1,
                          fault=hk.FAULT_STALE_RING_STAGE),
                      "hi-128": lambda: hk.window_attention(q, k, v, 0, tl - 128, scale=inv)}
            for fault, fn in faults.items():
                bad = hk.agreement(torch.cat(rows(fn()), dim=1), torch.cat(want, dim=1))
                phase("planted_fault", case=name, fault=fault, caught=not bad["within_tol"],
                      max_abs_err=bad["max_abs_err"], rel_fro_err=bad["rel_fro_err"])
                if bad["within_tol"]:
                    fail(f"{name}: the check passes the planted fault {fault}: {bad}")
        del q, k, v, got, want, qt, kt, vt, maxima
        torch.cuda.empty_cache()

    # -- K2-int8 at the same shape with t2v-14B's 40 heads, as the 14B
    # teacher's int8 QK^T route runs it (`teacher_14b` below): the s8 form
    # (the int8 pre-pass, then the kernel) against its plain version on the
    # same two row ranges (q is quantised per row, so a row range's quanta
    # are those of the whole call), the whole K/V. "ms" is the route as the
    # path runs it; "bf16_route_ms" the bf16 `window` route on the same q,
    # k, v; library_ms bf16 SDPA flash (no PyTorch call computes int8 QK^T
    # attention).
    name, nh = "teacher_self_32760_14b_int8qk", 40
    q = hk.prescale(rnd((1, tl, nh, hd)), hd ** -0.5)
    k, v = rnd((1, tl, nh, hd)), rnd((1, tl, nh, hd))
    seg = hk.segment_rows(tl)
    kern = lambda: hk.window_attention(q, k, v, 0, tl, scale=inv,  # noqa: E731
                                       route="window_int8qk")

    def rows(out):
        return [out[:, a:b] for a, b in row_ranges]

    got = rows(kern())
    want = [hk.window_attention_int8qk_plain(q[:, a:b], k, v, 0, tl, scale=inv)
            for a, b in row_ranges]
    torch.cuda.synchronize()
    res = hk.agreement(torch.cat(got, dim=1), torch.cat(want, dim=1))
    per_range = {f"rows_{a}_{b}": hk.agreement(g, w)["rel_fro_err"]
                 for (a, b), g, w in zip(row_ranges, got, want)}
    ms = cuda_ms(kern, 3)
    bf16_route_ms = cuda_ms(lambda: hk.window_attention(q, k, v, 0, tl, scale=inv,
                                                        route="window"), 3)
    plain_ms = cuda_ms(lambda: hk.window_attention_int8qk_plain(q[:, :1024], k, v, 0, tl,
                                                                scale=inv), 2)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=inv), 3)
    half = 2.0 * nh * hd * float(tl) * tl  # QK^T or PV
    bound_ms, bound_by = bound(2.0 * nh * hd * 4 * tl, half, "int8", [(half, "bf16")])
    teacher_k1[name] = dict(**res, **tol, rel_fro_by_rows=per_range, segment_rows=seg, ms=ms,
                            bf16_route_ms=bf16_route_ms, plain_ms_rows_1024=plain_ms,
                            library_ms=library_ms,
                            library="torch SDPA flash (bf16), unmasked: no PyTorch call "
                                    "computes int8 QK^T attention",
                            bound_ms=bound_ms, bound_by=bound_by)
    phase("kernel", kernel="attention", case=name, route="window_int8qk", lq=tl, lk=tl, lo=0,
          hi=tl, heads=nh, head_dim=hd, checked_rows=row_ranges, **teacher_k1[name],
          card=card)
    if not res["within_tol"]:
        fail(f"{name}: kernel outside the bounds {tol} of the plain version: {res}")
    # planted faults: the last ring stages filled with the previous tile; the
    # window's last 128 columns dropped
    faults = {"stale_ring_stage": lambda: hk._launch_int8(
                  q, k, v, inv, hk._MODE_WINDOW, 0, tl, 1, tl, -1, seg=seg,
                  fault=hk.FAULT_STALE_RING_STAGE),
              "hi-128": lambda: hk.window_attention(q, k, v, 0, tl - 128, scale=inv,
                                                    route="window_int8qk")}
    for fault, fn in faults.items():
        bad = hk.agreement(torch.cat(rows(fn()), dim=1), torch.cat(want, dim=1))
        phase("planted_fault", case=name, fault=fault, caught=not bad["within_tol"],
              max_abs_err=bad["max_abs_err"], rel_fro_err=bad["rel_fro_err"])
        if bad["within_tol"]:
            fail(f"{name}: the check passes the planted fault {fault}: {bad}")
    del q, k, v, got, want, qt, kt, vt
    torch.cuda.empty_cache()

    # -- the int8 QK^T mode (K2-int8, t2v-14B shapes) and the skewed routes
    # (K6a, K6b, t2v-1.3B shapes) of the wgmma kernel, each route named
    # explicitly; the same bounds as K1/K2. The int8 mode's plain version
    # computes the TPU kernel's per-segment mean, quanta and s32 scores; its
    # pre-pass's quanta are compared too. "ms" is the route as the main path
    # runs it (the int8 pre-pass, or the bound pre-pass for K6b, then the
    # kernel), "earlier_ms" the mma.sync route in the same turns, and
    # "bf16_route_ms" the bf16 `window` / `block_causal` route at the same
    # shape. No PyTorch call computes int8 QK^T attention: library_ms is bf16
    # SDPA on the same shape.
    mode_results = {}
    mode_cases = [  # (name, route, lq, lk, lo, hi or block, heads, scale, key offset)
        ("int8qk_self_14b", "window_int8qk", 4680, 9360, 1560, 9360, 40, 1.0, 0.0),
        ("int8qk_cross_14b", "window_int8qk", 4680, 512, 0, 512, 40, 1.0, 0.0),
        ("int8qk_block_causal_14b", "block_causal_int8qk", 4680, 4680, 0, 4680, 40, 1.0, 0.0),
        ("int8qk_shared_offset_14b", "window_int8qk", 4680, 9360, 1560, 9360, 40, 1.0, 2.0),
        ("skew_self", "window_skew", 4680, 9360, 1560, 9360, 12, 1.0, 0.0),
        ("skew_staticmax_self", "window_skew_staticmax", 4680, 9360, 1560, 9360, 12, 1.0, 0.0),
        ("skew_staticmax_large_norm", "window_skew_staticmax", 4680, 9360, 1560, 9360, 12,
         3.0, 0.0),
    ]
    for name, route, lq, lk, lo, arg, nh, scale, offset in mode_cases:
        q = hk.prescale(rnd((1, lq, nh, hd), scale), hd ** -0.5)
        k = (rnd((1, lk, nh, hd), scale).float() + offset * rnd((1, 1, nh, hd)).float()).to(
            torch.bfloat16)
        v = rnd((1, lk, nh, hd))
        int8 = route.endswith("int8qk")
        seg = hk.segment_rows(lk)
        if route == "block_causal_int8qk":
            kern = lambda: hk.block_causal_attention(q, k, v, arg, scale=inv,  # noqa: E731
                                                     route=route)
            plain = lambda: hk.block_causal_attention_int8qk_plain(  # noqa: E731
                q, k, v, arg, scale=inv)
            live_pairs = hk.block_causal_flops(lq, arg, nh, hd) / (4.0 * nh * hd)
            ks, vs, lib_mask = k.transpose(1, 2), v.transpose(1, 2), \
                hk.block_causal_mask(lq, lk, arg, lk, None, dev)
            lib_note = "torch SDPA with the boolean block mask (bf16)"
            v_bytes = 2.0 * nh * hd * lk
        else:
            kern = lambda: hk.window_attention(q, k, v, lo, arg, scale=inv,  # noqa: E731
                                               route=route)
            plain_fn = hk.window_attention_int8qk_plain if int8 else hk.window_attention_plain
            plain = lambda: plain_fn(q, k, v, lo, arg, scale=inv)  # noqa: E731
            live_pairs = float(lq * (arg - lo))
            ks, vs, lib_mask = k[:, lo:arg].transpose(1, 2), v[:, lo:arg].transpose(1, 2), None
            lib_note = "torch SDPA flash (bf16) on k[:, lo:hi]"
            v_bytes = 2.0 * nh * hd * (arg - lo)
        if int8:
            lib_note += ": no PyTorch call computes int8 QK^T attention"
        got, want = kern(), plain()
        torch.cuda.synchronize()
        res = hk.agreement(got, want, hk.sharp_atol(v) if scale > 1 else hk.ATOL)
        extra = {}
        if int8:
            extra = hk.quanta_agreement(hk.int8_qk_prepass(q, k, seg, inv),
                                        hk.int8_qk_prepass_plain(q, k, seg, inv))
            extra["quanta_within_tol"] = extra.pop("within_tol")
            extra["segment_rows"] = seg
            extra["prepass_ms"] = cuda_ms(lambda: hk.int8_qk_prepass(q, k, seg, inv), 10)
            bf16_route = "block_causal" if route == "block_causal_int8qk" else "window"
            extra["bf16_route_ms"] = cuda_ms(lambda: (
                hk.block_causal_attention(q, k, v, arg, scale=inv, route=bf16_route)
                if bf16_route == "block_causal" else
                hk.window_attention(q, k, v, lo, arg, scale=inv, route=bf16_route)), 10)
        else:
            extra["logit_bound"] = float(hk.logit_bound(q, k)[0])
        e_kern = None
        if earlier is not None:
            mode = hk._MODE_BLOCK_CAUSAL if route == "block_causal_int8qk" else hk._MODE_WINDOW
            e_args = (0, lk, arg, lk) if mode == hk._MODE_BLOCK_CAUSAL else (lo, arg, 1, lk)
            e_kern = lambda: earlier_mma(q, k, v, inv, mode, *e_args, int8,  # noqa: E731
                                         hk.static_max(route))
            res1 = hk.agreement(e_kern(), want, hk.sharp_atol(v) if scale > 1 else hk.ATOL)
            if not res1["within_tol"]:
                fail(f"{name}: the earlier kernel disagrees with the plain version: {res1}")
        ms, earlier_ms = ab_ms(kern, e_kern, 10)
        plain_ms = cuda_ms(plain, 2)
        qt = q.transpose(1, 2)
        backends = [SDPBackend.FLASH_ATTENTION] if lib_mask is None else [
            SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
        library_ms = None
        for b in backends:
            try:
                with sdpa_kernel([b]):
                    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                        qt, ks, vs, attn_mask=lib_mask, scale=inv), 5)
                lib_note += f" ({b.name})"
                break
            except RuntimeError:
                continue
        # bytes: q and the output once, k whole (the int8 mean reads every
        # row; the bf16 routes only the live ones), v's live rows
        k_bytes = 2.0 * nh * hd * lk if int8 else v_bytes
        io_bytes = 2.0 * nh * hd * 2 * lq + k_bytes + v_bytes
        half = 2.0 * nh * hd * live_pairs  # QK^T or PV
        if int8:
            bound_ms, bound_by = bound(io_bytes, half, "int8", [(half, "bf16")])
        else:
            bound_ms, bound_by = bound(io_bytes, 2 * half, "bf16")
        mode_results[name] = dict(**res, **tol, **extra, ms=ms, earlier_ms=earlier_ms,
                                  plain_ms=plain_ms,
                                  library_ms=library_ms, library=lib_note, bound_ms=bound_ms,
                                  bound_by=bound_by)
        phase("kernel", kernel="attention", case=name, route=route, lq=lq, lk=lk, lo=lo,
              arg=arg, heads=nh, head_dim=hd, key_offset=offset, **mode_results[name],
              card=card)
        if not res["within_tol"]:
            fail(f"{name}: kernel outside the bounds {tol} of the plain version: {res}")
        if int8 and not extra["quanta_within_tol"]:
            fail(f"{name}: the pre-pass's quanta differ from the plain version's: {extra}")
        faults = {}
        if name == "int8qk_shared_offset_14b":
            faults = {
                "one_mean_over_the_sequence": lambda: hk._launch_int8(
                    q, k, v, inv, hk._MODE_WINDOW, lo, arg, 1, lk, -1, seg=lk),
                "last_segment_k_scale_one_row_off": lambda: hk._launch_int8(
                    q, k, v, inv, hk._MODE_WINDOW, lo, arg, 1, lk, -1, seg=seg,
                    fault=hk.FAULT_K_SCALE_SHIFT),
                "stale_ring_stage": lambda: hk._launch_int8(
                    q, k, v, inv, hk._MODE_WINDOW, lo, arg, 1, lk, -1, seg=seg,
                    fault=hk.FAULT_STALE_RING_STAGE)}
        elif name in ("skew_self", "skew_staticmax_self"):
            maxima = hk.logit_bound_maxima(q, k, inv) if hk.static_max(route) else None
            faults = {"stale_ring_stage": lambda: hk._launch_sm90(
                q, k, v, inv, maxima, hk._MODE_WINDOW, lo, arg, 1, lk, -1,
                fault=hk.FAULT_STALE_RING_STAGE)}
        for fault, fn in faults.items():
            bad = hk.agreement(fn(), want)
            phase("planted_fault", case=name, fault=fault, caught=not bad["within_tol"],
                  max_abs_err=bad["max_abs_err"], rel_fro_err=bad["rel_fro_err"])
            if bad["within_tol"]:
                fail(f"{name}: the check passes the planted fault {fault}: {bad}")
        del q, k, v, got, want, qt, ks, vs, lib_mask
        torch.cuda.empty_cache()
    if mode_results["skew_staticmax_large_norm"]["logit_bound"] < hk.STATIC_MAX_LIMIT:
        fail("the large-norm case does not reach K6b's running-max fallback")
    if mode_results["skew_staticmax_self"]["logit_bound"] >= hk.STATIC_MAX_LIMIT:
        fail("the K6b self-attention case does not take the static-max path")

    # -- the fused int8 linear (K3) --
    # Quanta and s32 sums are the same on both sides (IEEE division, round
    # half to even, exact sums), so only the f32 epilogue's bf16 rounding may
    # differ: within 1 bf16 ulp elementwise.
    def ulps(got, want):
        _, exp = torch.frexp(want.float())
        ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), exp - 8).clamp_min(2.0 ** -126)
        return ((got.float() - want.float()).abs() / ulp).max().item()

    # The weights are K-major ([K, N] views of [N, K] storage, as the
    # loaders build them). The *_teacher cases are the 14B teacher's
    # train-mode forward over 32760 tokens (`teacher_14b`): M = 32760, the
    # last 128-row tile holding 120.
    mm_results = {}
    mm_cases = [("qkv", 4680, 1536, 4608, True), ("fc1", 4680, 1536, 8960, True),
                ("fc2", 4680, 8960, 1536, True), ("o_dynamic", 4680, 1536, 1536, False),
                ("qkv_14b", 4680, 5120, 15360, True), ("fc2_14b", 4680, 13824, 5120, True),
                ("qkv_14b_teacher", 32760, 5120, 15360, True),
                ("fc2_14b_teacher", 32760, 13824, 5120, True),
                ("o_14b_teacher_dynamic", 32760, 5120, 5120, False)]
    for name, m, kdim, n, static in mm_cases:
        x = rnd((1, m, kdim))
        w_q, bias = hm.k_major(rint8((kdim, n))), rnd((n,))
        w_scale = (torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-3)
        a_scale = (x.float().abs().amax() * 1.5 / 127.0).reshape(1) if static \
            else hm.dynamic_scale(x)
        kern = lambda: hm.int8_linear(x, w_q, w_scale, a_scale, bias)  # noqa: E731
        plain = lambda: hm.int8_linear_plain(x, w_q, w_scale, a_scale, bias)  # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err_ulps = ulps(got, want)
        max_abs = (got.float() - want.float()).abs().max().item()
        ms, earlier_ms = cuda_ms(kern, 20), None  # K3 has no replaced version here
        plain_ms = cuda_ms(plain, 3)
        x2 = x.reshape(m, kdim)

        def library():  # quantise, torch._int_mm, dequantise: one PyTorch call each
            xq = hm.quantize(x2, a_scale)
            return hm.dequantize(torch._int_mm(xq, w_q), a_scale, w_scale, bias, x.dtype)

        try:
            library_ms, lib_note = cuda_ms(library, 10), "quantise + torch._int_mm + epilogue"
        except RuntimeError as e:
            library_ms, lib_note = None, f"torch._int_mm refused: {e}"
        bf16_w = rnd((kdim, n))
        bf16_matmul_ms = cuda_ms(lambda: torch.matmul(x, bf16_w), 10)
        bound_ms, bound_by = bound(hm.int8_linear_bytes(m, kdim, n),
                                   hm.int8_linear_ops(m, kdim, n), "int8")
        mm_results[name] = dict(max_abs_err=max_abs, max_err_bf16_ulps=err_ulps, ms=ms,
                                earlier_ms=earlier_ms, plain_ms=plain_ms,
                                library_ms=library_ms, library=lib_note,
                                bf16_matmul_ms=bf16_matmul_ms, bound_ms=bound_ms,
                                bound_by=bound_by,
                                tops=hm.int8_linear_ops(m, kdim, n) / ms / 1e9)
        phase("kernel", kernel="int8_linear", case=name, m=m, k=kdim, n=n,
              static_scale=static, tol_bf16_ulps=1, **mm_results[name], card=card)
        if not (err_ulps <= 1.0 and torch.isfinite(got).all()):
            fail(f"int8 linear {name}: {err_ulps} bf16 ulps from the plain version")
        if name == "qkv":
            for fault, code in (("last_k_tile_dropped", hm.FAULT_DROP_LAST_K_TILE),
                                ("w_scale_one_column_off", hm.FAULT_W_SCALE_SHIFT),
                                ("stale_ring_stage", hm.FAULT_STALE_RING_STAGE)):
                bad = ulps(hm._launch(x, w_q, w_scale, a_scale, bias, fault=code), want)
                phase("planted_fault", case=f"int8_linear_{name}", fault=fault,
                      caught=bad > 1.0, max_err_bf16_ulps=bad)
                if bad <= 1.0:
                    fail(f"the int8 linear check passes the planted fault {fault}")
        del x, w_q, bias, got, want, bf16_w, x2
        torch.cuda.empty_cache()

    # -- the kt x 3 x 3 conv (K4/K5) --
    # Weights are the K-major views the int8 VAE stores (hc.k_major), inputs
    # with their pixels padded to 32 bytes (hc.pad_channels, as the quantise
    # pre-pass writes them). s8: the int32 sums must equal the plain
    # version's and the fused dequantise (the main path's form, "ms") the
    # torch dequantise of those sums, bit for bit; "route_ms" is the int8 VAE
    # conv as models/vae.py runs it (pre-pass + fused conv, from bf16), and
    # its earlier counterpart (torch quantise, the mma.sync conv on the
    # Co-contiguous w, torch dequantise). bf16: hk.agreement's bounds, with
    # cuDNN's F.conv3d as the same-function library call.
    pad1, down = ((1, 1), (1, 1)), ((0, 1), (0, 1))
    conv_results = {}
    conv_cases = [  # (name, dtype, T_in, H, W, C, Co, kt, stride, padding)
        ("s8_kt3_c384_60x104", torch.int8, 3, 60, 104, 384, 384, 3, (1, 1), pad1),
        ("s8_kt3_c96_480x832", torch.int8, 6, 480, 832, 96, 96, 3, (1, 1), pad1),
        ("s8_head_kt3_c96_co3_480x832", torch.int8, 6, 480, 832, 96, 3, 3, (1, 1), pad1),
        ("s8_first_kt3_c16_co384_60x104", torch.int8, 3, 60, 104, 16, 384, 3, (1, 1), pad1),
        ("s8_kt1_c96_480x832", torch.int8, 1, 480, 832, 96, 96, 1, (1, 1), pad1),
        ("s8_kt1_c3_480x832", torch.int8, 1, 480, 832, 3, 96, 1, (1, 1), pad1),
        ("s8_stride2_c96_480x832", torch.int8, 1, 480, 832, 96, 96, 1, (2, 2), down),
        ("bf16_kt3_bias_c384_60x104", torch.bfloat16, 3, 60, 104, 384, 384, 3, (1, 1), pad1),
    ]
    for name, dtype, t, h, w, c, co, kt, stride, padding in conv_cases:
        s8 = dtype == torch.int8
        (ph0, ph1), (pw0, pw1) = padding
        extra = {}
        if s8:
            xf = rnd((t, h, w, c), 2.0)  # the bf16 activation the route quantises
            a_scale = hm.dynamic_scale(xf)
            x_plain = hm.quantize(xf, a_scale.reshape(()))
            w_plain, b = rint8((kt, 3, 3, c, co)), None
            scale, bq = torch.rand((co,), generator=gen, device=dev) * 2e-3 + 1e-3, rnd((co,))
        else:
            x_plain, w_plain = rnd((t, h, w, c)), rnd((kt, 3, 3, c, co), (kt * 9 * c) ** -0.5)
            b = rnd((co,))
        x, wt = hc.pad_channels(x_plain), hc.k_major(w_plain)
        plain = lambda: hc.conv3x3_plain(x, wt, stride, padding, bias=b)  # noqa: E731
        want = plain()
        if s8:
            kern = lambda: hc.conv3x3_dequant(x, wt, a_scale, scale, bq, stride,  # noqa: E731
                                              padding)
            got32 = hc.conv3x3(x, wt, stride, padding)
            got = kern()
            torch.cuda.synchronize()
            want_dq = hc.dequantize_plain(want, a_scale, scale, bq, torch.bfloat16)
            res = {"equal_int32": torch.equal(got32, want),
                   "dequant_bit_equal": torch.equal(got.view(torch.int16),
                                                    want_dq.view(torch.int16))}
            ok = res["equal_int32"] and res["dequant_bit_equal"]
            max_abs = (got32.double() - want.double()).abs().max().item()
            route = lambda: hc.int8_conv(xf, wt, a_scale, scale, bq, stride,  # noqa: E731
                                         padding)
            extra["s32_ms"] = cuda_ms(lambda: hc.conv3x3(x, wt, stride, padding), 10)
            e_kern = e_route = None
            if earlier is not None:
                x_c, w_c = x_plain.contiguous(), w_plain.contiguous()
                if not torch.equal(earlier_conv(x_c, w_c, stride, padding), want):
                    fail(f"conv {name}: the earlier kernel disagrees with the plain version")
                e_kern = lambda: hc.dequantize_plain(  # noqa: E731
                    earlier_conv(x_c, w_c, stride, padding), a_scale, scale, bq, torch.bfloat16)
                e_route = lambda: hc.dequantize_plain(earlier_conv(  # noqa: E731
                    hm.quantize(xf, a_scale.reshape(())).contiguous(), w_c, stride, padding),
                    a_scale, scale, bq, torch.bfloat16)
            extra["route_ms"], extra["earlier_route_ms"] = ab_ms(route, e_route, 10)
            ms, earlier_ms = ab_ms(kern, e_kern, 10)
            lib_dtype = torch.bfloat16  # cuDNN has no s8 conv: a bf16 one, another function
        else:
            kern = lambda: hc.conv3x3(x, wt, stride, padding, bias=b)  # noqa: E731
            got = kern()
            torch.cuda.synchronize()
            res = hk.agreement(got, want)
            ok = res["within_tol"]
            max_abs = (got.float() - want.float()).abs().max().item()
            e_kern = None
            if earlier is not None:
                w_c = w_plain.contiguous()
                e_kern = lambda: earlier_conv(x_plain, w_c, stride, padding, b)  # noqa: E731
            ms, earlier_ms = ab_ms(kern, e_kern, 10)
            lib_dtype = dtype
        plain_ms = cuda_ms(plain, 1)
        xl = F.pad(rnd((t, h, w, c)).permute(3, 0, 1, 2)[None], (pw0, pw1, ph0, ph1))
        wl = rnd((co, c, kt, 3, 3), (kt * 9 * c) ** -0.5).to(lib_dtype)
        bl = rnd((co,))
        cudnn_ms = cuda_ms(lambda: F.conv3d(xl, wl, bl, stride=(1, *stride)), 10)
        del xl, wl, bl
        if s8:
            library_ms, lib_note = None, "no PyTorch call computes an s8 convolution on CUDA"
            extra["bf16_cudnn_ms"] = cudnn_ms
            extra["bf16_cudnn"] = "cuDNN F.conv3d in bf16 + bias, TF32 off (another function)"
        else:
            library_ms, lib_note = cudnn_ms, "cuDNN F.conv3d (bf16 + bias, TF32 off)"
        ops = hc.conv3x3_ops(x.shape, wt.shape, stride, padding)
        bound_ms, bound_by = bound(
            hc.conv3x3_bytes(x.shape, wt.shape, stride, padding, in_bytes=1 if s8 else 2,
                             out_bytes=2, bias=True),
            ops, "int8" if s8 else "bf16")
        conv_results[name] = dict(res, **extra, max_abs_err=max_abs, ms=ms,
                                  earlier_ms=earlier_ms, plain_ms=plain_ms,
                                  library_ms=library_ms, library=lib_note, bound_ms=bound_ms,
                                  bound_by=bound_by, tops=ops / ms / 1e9)
        phase("kernel", kernel="conv3x3", case=name, shape=[t, h, w, c], co=co, kt=kt,
              stride=list(stride), padding=[list(p) for p in padding],
              check="int32 equal, fused dequantise bit-equal" if s8 else
              f"agreement atol {hk.ATOL} rtol {hk.RTOL} rel_fro {hk.REL_FRO}",
              **conv_results[name], card=card)
        if not ok:
            fail(f"conv {name}: kernel disagrees with its plain version: {res}")
        if name in ("s8_kt3_c384_60x104", "bf16_kt3_bias_c384_60x104"):
            for fault, code in (("halo_row_zeroed", hc.FAULT_ZERO_HALO_ROW),
                                ("last_32_bytes_of_channels_dropped", hc.FAULT_DROP_LAST_C32),
                                ("stale_ring_stage", hc.FAULT_STALE_RING_STAGE),
                                ("tap_dx2_reads_tap_dx1_rows", hc.FAULT_TAP_ROWS)):
                bad = hc._launch(x, wt, stride, padding, b, fault=code)
                caught = not torch.equal(bad, want) if s8 else \
                    not hk.agreement(bad, want)["within_tol"]
                phase("planted_fault", case=f"conv3x3_{name}", fault=fault, caught=caught,
                      elements_differing=int((bad != want).sum()))
                if not caught:
                    fail(f"the conv check passes the planted fault {fault}")
        del x, wt, b, got, want
        torch.cuda.empty_cache()

    # -- the int8 VAE encoder's convolutions at a webcam block's shapes --
    # Every launch of the conv kernel during the encode of block 0 (9 frames,
    # fresh: chunks 1, 4, 4) and of a warm block (12 frames streamed through
    # the cache: 4, 4, 4) at 480x832 is recorded by its form; each form that
    # the cases above do not hold is held the same way (int32 sums equal,
    # fused dequantise bit-equal) on random s8 operands of its shapes.
    int8_flags = {"enable_int8": True, "enable_int8_dit": True, "int8_static_scales": True}
    int8_config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                     timestep_shift=5.0, **int8_flags)
    vae8 = load_vae(int8_config, dev, seed=1)

    def recorded_forms(fn):
        """(fn(), {form: launches}) with each conv launch's form recorded:
        (x shape [T, H, W, C], w shape [kt, 3, 3, C, Co], stride, padding)."""
        forms, launch = {}, hc._launch

        def record(x, w, stride=(1, 1), padding=((1, 1), (1, 1)), bias=None, fault=0,
                   dequant=None):
            key = (tuple(x.shape), tuple(w.shape), tuple(stride),
                   tuple(tuple(p) for p in padding))
            forms[key] = forms.get(key, 0) + 1
            return launch(x, w, stride, padding, bias, fault, dequant)

        hc._launch = record
        try:
            return fn(), forms
        finally:
            hc._launch = launch

    cam = torch.rand((21, 3, 480, 640), generator=gen, device=dev) * 2.0 - 1.0

    def encode(frames, cache, stream):
        return session_mod.encode_video_latent(vae8, cache, frames=frames, height=480,
                                               width=832, stream=stream)

    (z0, cache0), block0_forms = recorded_forms(lambda: encode(cam[:9], None, False))
    (z1, _), warm_forms = recorded_forms(lambda: encode(cam[9:], cache0, True))
    torch.cuda.synchronize()
    encode_ms = {"block0_fresh_9_frames": cuda_ms(lambda: encode(cam[:9], None, False), 3),
                 "warm_streamed_12_frames": cuda_ms(lambda: encode(cam[9:], cache0, True), 3)}
    encode_launches = {
        "block0": {"kt1": sum(n for f, n in block0_forms.items() if f[1][0] == 1),
                   "kt3": sum(n for f, n in block0_forms.items() if f[1][0] > 1)},
        "warm": {"kt1": sum(n for f, n in warm_forms.items() if f[1][0] == 1),
                 "kt3": sum(n for f, n in warm_forms.items() if f[1][0] > 1)}}
    if not (z0.shape == (3, 16, 60, 104) and z1.shape == (3, 16, 60, 104)
            and torch.isfinite(z0).all() and torch.isfinite(z1).all()):
        fail(f"webcam encode: latents {tuple(z0.shape)} {tuple(z1.shape)}")
    held = {(t, h, w, c, co, kt, tuple(st), tuple(tuple(p) for p in pad))
            for _, dt, t, h, w, c, co, kt, st, pad in conv_cases if dt == torch.int8}
    all_forms = dict(block0_forms)
    for f, n in warm_forms.items():
        all_forms[f] = all_forms.get(f, 0) + n
    encoder_forms = []
    for (xs, ws, st, pad), n in sorted(all_forms.items()):
        t, h, w, c = xs
        kt, co = ws[0], ws[-1]
        already = (t, h, w, c, co, kt, st, pad) in held
        row = dict(x=list(xs), w=list(ws), stride=list(st), padding=[list(p) for p in pad],
                   launches_block0=block0_forms.get((xs, ws, st, pad), 0),
                   launches_warm_block=warm_forms.get((xs, ws, st, pad), 0),
                   held_above=already)
        if not already:
            x = hc.pad_channels(rint8((t, h, w, c)))
            wt = hc.k_major(rint8((kt, 3, 3, c, co)))
            scale = torch.rand((co,), generator=gen, device=dev) * 2e-3 + 1e-3
            a_scale, bq = torch.tensor(2.0 / 127.0, device=dev), rnd((co,))
            want = hc.conv3x3_plain(x, wt, st, pad)
            got = hc.conv3x3_dequant(x, wt, a_scale, scale, bq, st, pad)
            row["equal_int32"] = torch.equal(hc.conv3x3(x, wt, st, pad), want)
            want_dq = hc.dequantize_plain(want, a_scale, scale, bq, torch.bfloat16)
            row["dequant_bit_equal"] = torch.equal(got.view(torch.int16),
                                                   want_dq.view(torch.int16))
            row["ms"] = cuda_ms(lambda: hc.conv3x3_dequant(x, wt, a_scale, scale, bq, st, pad),
                                10)
            row["bound_ms"], row["bound_by"] = bound(
                hc.conv3x3_bytes(x.shape, wt.shape, st, pad, in_bytes=1, out_bytes=2,
                                 bias=True), hc.conv3x3_ops(x.shape, wt.shape, st, pad), "int8")
            del x, wt, want, got, want_dq
        encoder_forms.append(row)
        phase("kernel", kernel="conv3x3", case="webcam_encoder_form", **row, card=card)
        if not already and not (row["equal_int32"] and row["dequant_bit_equal"]):
            fail(f"conv form {row}: kernel disagrees with its plain version")
    encoder_forms_checked = {
        "kt1": sum(not r["held_above"] and r["w"][0] == 1 for r in encoder_forms),
        "kt3": sum(not r["held_above"] and r["w"][0] > 1 for r in encoder_forms)}
    phase("webcam_encode", frames_in="640x480 -> 832x480", encode_ms=encode_ms,
          launches=encode_launches, forms=len(encoder_forms),
          forms_checked_here=sum(not r["held_above"] for r in encoder_forms), card=card)
    del vae8, cam, z0, z1, cache0
    torch.cuda.empty_cache()

    # -- the int8 quantisers on the card against the CPU (the repaired scale
    # division): one t2v-1.3B DiT layer and the whole Wan 2.1 VAE at full
    # width, from the same f32 weights; static activation scales from a seed
    rng_np = np.random.default_rng(12)
    one_layer = dataclasses.replace(WAN_CONFIGS["t2v-1.3B"], num_layers=1)
    dit_f32 = wan_dit.fuse_qkv_params(wan_dit.init_wan_params(
        one_layer, torch.Generator().manual_seed(12), "cpu", torch.float32))
    sites = wan_dit._calib_site_order(dit_f32["blocks"])
    dit_act = {s_: torch.from_numpy(rng_np.uniform(0.1, 40.0, size=1)) for s_ in sites}
    vae_f32 = vae_mod.init_vae_params(VAE_CONFIGS["wan2.1"], torch.Generator().manual_seed(13),
                                      "cpu", torch.float32)
    vae_act = {path: float(rng_np.uniform(0.1, 40.0)) for path, _ in vae_mod._walk_paths(vae_f32)}
    repair = {}
    for name, tree, quantise in (
            ("dit_layer", dit_f32, lambda t: wan_dit.quantize_wan_linears(t, act_scales=dit_act)),
            ("vae", vae_f32, lambda t: vae_mod.quantize_vae_params(t, act_scales=vae_act))):
        tree_gpu = tree_to(tree, dev)
        on_gpu = quantise(tree_gpu)
        differing = bits_differing(quantise(tree), on_gpu)
        # the fault repaired: a Python-scalar divisor, which PyTorch turns into
        # a multiply by its reciprocal on a card, gives other weight scales
        scalar_off = sum(int((a / 127.0 != a / torch.full_like(a, 127.0)).sum())
                         for a in weight_amaxes(tree_gpu))
        del tree_gpu
        repair[name] = dict(leaves=len(differing), elements_differing=sum(differing.values()),
                            bad_leaves=[p_ for p_, n in differing.items() if n],
                            scale_elements_a_scalar_divisor_would_change=scalar_off)
        del on_gpu
    phase("int8_scales_card_vs_cpu", **repair, card=card)
    for name, r in repair.items():
        if r["elements_differing"] or not r["leaves"]:
            fail(f"{name}: the int8 tree built on the card differs from the CPU's: {r}")
    del dit_f32, vae_f32
    torch.cuda.empty_cache()

    # -- umT5-xxl at full width: a 2-layer slice on the card (bf16) against
    # the CPU's f32 forward of the same weights, over the prompt's tokens
    t5_two = dataclasses.replace(T5_CONFIGS["umt5-xxl"], num_layers=2)
    p_t5 = t5_mod.init_t5_encoder_params(t5_two, torch.Generator(device=dev).manual_seed(3),
                                         dev, torch.bfloat16)
    ids, mask = FallbackTokenizer(seq_len=t5_two.text_len)(["a red fox running through snow"])
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    t5_card = t5_mod.encode_prompts(t5_two, p_t5, ids.to(dev), mask.to(dev)).float().cpu()
    t5_cpu = t5_mod.encode_prompts(t5_two, tree_to(p_t5, "cpu", torch.float32), ids, mask)
    tokens = int(mask.sum())
    cos_t5 = cosine(t5_card[0, :tokens], t5_cpu[0, :tokens])
    padding_zero = not t5_card[0, tokens:].any()
    phase("umt5_slice_vs_cpu", layers=2, dim=t5_two.dim, vocab=t5_two.vocab_size,
          tokens=tokens, length=t5_two.text_len, cosine=cos_t5, bar=0.999,
          padding_zero=padding_zero, card=card)
    if not (cos_t5 > 0.999 and padding_zero and torch.isfinite(t5_card).all()):
        fail(f"umT5 slice on the card disagrees with the CPU: cosine {cos_t5}")
    del p_t5, t5_card, t5_cpu
    torch.cuda.empty_cache()

    # -- TAEHV, the preview tier's decoder (cuDNN convs, as the JAX package
    # leaves them to XLA): card against CPU on the same random init at a
    # reduced size (3 latents of 30x52 -> 12 frames of 240x416), f32 with
    # TF32 off within relative Frobenius 1e-3, bf16 within 3e-2 (bf16 on the
    # CPU reads 1.1e-2 against f32 at 16x20); then one 832x480 block (3
    # latents -> 12 frames) in bf16 with its carried state, as a session
    # decodes it, timed beside its bound
    def rel_fro(got, want):
        got, want = got.float().cpu(), want.float().cpu()
        return float((got - want).norm() / want.norm())

    tg = torch.Generator().manual_seed(3)
    taehv_cpu = taehv_mod.init_taehv_params(tg, "cpu", torch.float32)
    z_small = torch.randn((1, 3, 16, 30, 52), generator=tg)
    want_px, _ = taehv_mod.taehv_decode(taehv_cpu, z_small)
    got32, _ = taehv_mod.taehv_decode(tree_to(taehv_cpu, dev), z_small.to(dev))
    taehv_bf16 = tree_to(taehv_cpu, dev, torch.bfloat16)
    got16, _ = taehv_mod.taehv_decode(taehv_bf16, z_small.to(dev, torch.bfloat16))
    rel32, rel16 = rel_fro(got32, want_px), rel_fro(got16, want_px)
    phase("taehv_decode_card_vs_cpu", latents=list(z_small.shape), frames=got32.shape[1],
          f32_rel_fro=rel32, f32_bar=1e-3, bf16_rel_fro=rel16, bf16_bar=3e-2,
          tf32=torch.backends.cudnn.allow_tf32, card=card)
    if not (rel32 < 1e-3 and rel16 < 3e-2 and tuple(got32.shape) == tuple(want_px.shape)):
        fail(f"TAEHV decode on the card disagrees with the CPU: f32 {rel32}, bf16 {rel16}")
    z_full = rnd((1, 3, 16, 60, 104))
    px_full, taehv_state = taehv_mod.taehv_decode(taehv_bf16, z_full)
    taehv_ms = cuda_ms(lambda: taehv_mod.taehv_decode(taehv_bf16, z_full, taehv_state), 10)
    taehv_macs, taehv_bytes = taehv_mod.decode_work(3, 60, 104, itemsize=2)
    taehv_bound_ms, taehv_bound_by = bound(taehv_bytes, 2 * taehv_macs, "bf16")
    phase("taehv_decode_832x480", latents=list(z_full.shape), frames=px_full.shape[1],
          ms=taehv_ms, bound_ms=taehv_bound_ms, bound_by=taehv_bound_by,
          tflop=2 * taehv_macs / 1e12, bytes_gb=taehv_bytes / 1e9,
          tflops=2 * taehv_macs / taehv_ms / 1e9, library="F.conv2d (cuDNN), bf16, "
          "channels-last", finite=bool(torch.isfinite(px_full).all()), card=card)
    if not (px_full.shape[1] == 12 and torch.isfinite(px_full).all()):
        fail(f"TAEHV decode of a 832x480 block: {tuple(px_full.shape)}")
    del taehv_cpu, got32, got16, taehv_bf16, px_full, taehv_state
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

    # the teacher's train-mode forward at t2v-1.3B's full width (dim 1536, 12
    # heads) with 2 layers, 3 latent frames at 832x480 (4680 tokens, each
    # attending to all), a random head and no mask: the card's bf16 against
    # the CPU's f32 at the same bar
    wide = dataclasses.replace(WAN_CONFIGS["t2v-1.3B"], num_layers=2)
    p_cpu = wan_dit.fuse_qkv_params(wan_dit.init_wan_params(wide, cpu_gen, "cpu",
                                                            torch.float32))
    p_cpu["head"]["head"]["w"] = torch.randn(p_cpu["head"]["head"]["w"].shape,
                                             generator=cpu_gen) * 0.05
    p_gpu = to_gpu(p_cpu)
    ctx = torch.randn((1, 512, wide.text_dim), generator=cpu_gen)
    lat = torch.randn((1, 3, 16, 60, 104), generator=cpu_gen)
    t = torch.tensor([[937.0, 500.0, 120.0]])
    outs = {}
    for name, params, device, dtype in (("cpu", p_cpu, "cpu", torch.float32),
                                        ("gpu", p_gpu, dev, torch.bfloat16)):
        for m in kernel_mods:
            m.reset_launch_counts()
        rope = RopeTables.create(wide.head_dim, device=device)
        cross = wan_dit.compute_crossattn_cache(wide, params, ctx.to(device, dtype))
        flow, kv = wan_dit.dit_forward(wide, params, lat.to(device, dtype), t.to(device), rope,
                                       cross, "train")
        outs[name] = flow.float().cpu()
    launches_tf, plain_tf = read_counts()
    rel = ((outs["gpu"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()
    phase("teacher_forward_small_vs_cpu", layers=wide.num_layers, dim=wide.dim,
          heads=wide.num_heads, tokens=3 * 1560, rel_max_err=rel, tol=5e-2,
          launches=launches_tf, plain_on_cuda=plain_tf, shape=list(outs["gpu"].shape),
          card=card)
    if not (rel < 5e-2 and torch.isfinite(outs["gpu"]).all() and kv is None):
        fail(f"the train-mode forward on the card disagrees with the CPU: {rel}")
    if launches_tf.get("window") != 2 * wide.num_layers or any(plain_tf.values()):
        fail(f"the train-mode forward: K1 launches {launches_tf}, plain on CUDA {plain_tf}")
    del p_cpu, p_gpu, outs, cross
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4: the server: 1.3B bf16 (+ skew sessions), 1.3B int8 (the
    # static embedding, then umT5 with the video-in sessions), the checkpoint
    # path, 14B int8 ----
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

    def load(config, umt5=False):
        """load_all on the card, serving the static embedding, or load_all's
        default text encoder (umT5-xxl) when `umt5`."""
        if umt5:
            os.environ.pop("USE_STATIC_ENCODER_COND_DICT", None)
        try:
            return load_all(config, dev, seed=0)
        finally:
            os.environ["USE_STATIC_ENCODER_COND_DICT"] = "1"

    os.environ["USE_STATIC_ENCODER_COND_DICT"] = "1"

    async def start_app(config, models):
        runner = web.AppRunner(server_mod.create_app(config, models))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"

    async def receive_all(ws, sid, stamps, sizes, on_frame=None):
        """Frames (their arrival times and sizes) until the final text message,
        which it returns; on_frame(count) runs after each frame."""
        while True:
            msg = await ws.receive(timeout=600)
            if msg.type == WSMsgType.BINARY:
                stamps.append(time.perf_counter())
                sizes.append(len(msg.data))
                if on_frame is not None:
                    await on_frame(len(stamps))
            elif msg.type == WSMsgType.TEXT:
                return msg.json()
            else:
                fail(f"{sid}: socket closed before completion ({msg.type})")

    async def drive(config, models, specs):
        """One WebSocket session after another, each (sid, request, a mid-stream
        message sent after its first frame or None); returns per session
        (sid, t_send, stamps, sizes, final, the frames the server encoded)."""
        runner, base = await start_app(config, models)
        sessions = []
        try:
            async with ClientSession() as client:
                for sid, req, midstream in specs:
                    async with client.ws_connect(f"{base}/session/{sid}", max_msg_size=0) as ws:
                        ready = await ws.receive_json(timeout=60)
                        if ready.get("status") != "ready":
                            fail(f"{sid}: no ready message: {ready}")
                        encoded.clear()
                        stamps, sizes = [], []

                        async def after_first(n, ws=ws, midstream=midstream):
                            if n == 1 and midstream is not None:
                                await ws.send_bytes(packb(midstream))

                        t_send = time.perf_counter()
                        await ws.send_bytes(packb(req))
                        final = await receive_all(ws, sid, stamps, sizes, after_first)
                        sessions.append((sid, t_send, stamps, sizes, final, list(encoded)))
        finally:
            await runner.cleanup()
        return sessions

    async def upload(route, data, filename):
        """POST one file to an upload endpoint; returns the saved file's path."""
        runner, base = await start_app({}, object())
        try:
            async with ClientSession() as client:
                form = FormData()
                form.add_field("file", data, filename=filename)
                async with client.post(f"{base}{route}", data=form) as r:
                    body = await r.json()
                    if r.status != 200:
                        fail(f"{route}: {r.status} {body}")
                    return body["path"]
        finally:
            await runner.cleanup()

    def t2v_specs(sids, req=None):
        return [(sid, req or request, None) for sid in sids]

    head_gen = torch.Generator(device=dev).manual_seed(11)

    def block0_x0(config, models, head_w):
        """Block 0's x0 of a direct session, with the DiT head given random
        weights (its init is zero, which would make every flow zero)."""
        head = models.transformer.params["head"]["head"]
        saved = head["w"]
        head["w"] = head_w.to(saved.dtype)
        try:
            session = GenerationSession(GenerateParams(**request), config, models=models,
                                        frame_callback=lambda *a: None)
            session.generate_block_internal(models)
            return session.all_latents[:, :3].float().cpu()
        finally:
            head["w"] = saved

    def random_head(models):
        shape = models.transformer.params["head"]["head"]["w"].shape
        return torch.randn(shape, generator=head_gen, device=dev) * 0.05

    def session_stats(label, sid, t_send, stamps, sizes, final, frames, blocks, first=6,
                      **extra):
        """Check one session's frames (`first` + 12 (blocks - 1): block 0
        sends 6 with the Wan decoder, 9 with TAEHV; finite, 832x480) and
        report its times at the client."""
        n_frames = first + 12 * (blocks - 1)
        if final != {"session_id": sid, "status": "completed"}:
            fail(f"{sid}: final message {final}")
        if len(stamps) != n_frames:
            fail(f"{sid}: {len(stamps)} frames, expected {n_frames}")
        if len(frames) != n_frames or any(shape != (3, 480, 832) or not finite
                                          for shape, finite, _ in frames):
            fail(f"{sid}: encoded frames {[(s_, f_) for s_, f_, _ in frames]}")
        ends = [stamps[first - 1 + 12 * b] for b in range(blocks)]  # a block's last frame
        stats = dict(ttff_ms=(stamps[0] - t_send) * 1e3,
                     block_ms=[(b - a) * 1e3 for a, b in zip([t_send] + ends, ends)],
                     fps_warm=12 * (blocks - 1) / (ends[-1] - ends[0]) if blocks > 1 else None,
                     fps_session=n_frames / (ends[-1] - t_send))
        phase("session", tier=label, session=sid, frames=len(stamps),
              jpeg_bytes_mean=float(np.mean(sizes)), **stats, **extra,
              pixel_mean=float(np.mean([m for _, _, m in frames])), card=card)
        return stats

    def serve(config, models, specs, label, required, blocks=3, first=6):
        """Drive the sessions with every launch count set to 0 just before and
        read just after; check each session's frames, that every kernel in
        `required` launched, and that no plain version saw a CUDA tensor."""
        for m in kernel_mods:
            m.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        sessions = asyncio.run(drive(config, models, specs))
        launches, plain_on_cuda = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        stats = [session_stats(label, *s_, blocks=blocks, first=first) for s_ in sessions]
        missing = [k for k in required if launches.get(k, 0) <= 0]
        if missing:
            fail(f"{label}: kernels of the path not launched: {missing} ({launches})")
        if any(plain_on_cuda.values()):
            fail(f"{label}: a plain version ran on a CUDA tensor: {plain_on_cuda}")
        server_mod.session_frames_storage.clear()  # kept for /download_video
        return launches, plain_on_cuda, peak_gb, stats

    teacher_prompt = "a red fox running through snow"

    def timed_forwards(gen, labels):
        """Wrap gen.forward so that each call is timed with CUDA events; the
        calls take `labels` in turn. Returns (events, restore)."""
        events, forward = [], gen.forward

        def timed(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = forward(*a, **k)
            e1.record()
            events.append((labels[len(events) % len(labels)], e0, e1))
            return out

        gen.forward = timed
        return events, lambda: delattr(gen, "forward")

    def forward_ms(events):
        torch.cuda.synchronize()
        out = {}
        for label, e0, e1 in events:
            out.setdefault(label, []).append(e0.elapsed_time(e1))
        return out

    def run_teacher(label, gen, fn, labels, want_window, **extra):
        """One teacher phase on `gen`: every launch count set to 0 just
        before fn() and read just after; the forwards timed apart; the output
        must be 81 finite frames of 832x480; K1 (and its bound pre-pass) must
        launch exactly `want_window` times and no plain version may see a
        CUDA tensor."""
        gc.collect()
        torch.cuda.empty_cache()
        for m in kernel_mods:
            m.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        events, restore = timed_forwards(gen, labels)
        t0 = time.perf_counter()
        try:
            video, lat, prof = fn()
        finally:
            restore()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, plain_on_cuda = read_counts()
        fwd = forward_ms(events)
        finite = bool(torch.isfinite(video).all() and (lat is None or torch.isfinite(lat).all()))
        phase(label, model="t2v-1.3B", tier="bf16", tokens=21 * 1560,
              frames=list(video.shape), wall_s=wall_s,
              forward_ms=fwd, forwards=len(events), **prof,
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
              plain_on_cuda=plain_on_cuda, k1_launches_expected=want_window, finite=finite,
              **extra, card=card)
        if not finite or tuple(video.shape[-4:]) != (81, 3, 480, 832):
            fail(f"{label}: frames {tuple(video.shape)}, finite {finite}")
        if (launches["window"] != want_window or launches["logit_bound"] != want_window
                or any(plain_on_cuda.values())):
            fail(f"{label}: K1 launches {launches['window']} / bound pre-passes "
                 f"{launches['logit_bound']}, expected {want_window}; plain on CUDA "
                 f"{plain_on_cuda}")
        return dict(launches=launches, forward_ms=fwd, wall_s=wall_s, **prof)

    def teacher_phases(models, head_w):
        """The 50-step teacher's path on the bf16 tier's models (the teacher's
        precision), at full depth and width, over a whole 81-frame clip at
        832x480 (21 latents, 32760 tokens), the DiT head random (as in
        block0_x0), prompts from SeededTextEncoder: WanT2V.generate with 4
        UniPC steps, the few-step bidirectional sampler on the default step
        list, and the block-causal CFG sampler with 2 steps a block."""
        gen_t, vae = models.transformer, models.vae_decoder
        layers = gen_t.cfg.num_layers
        head = gen_t.params["head"]["head"]
        saved, head["w"] = head["w"], head_w.to(head["w"].dtype)
        enc = SeededTextEncoder(dev)
        out = {}
        try:
            steps = 4
            wan = WanT2V(gen_t, enc, vae, sample_solver="unipc", sampling_steps=steps,
                         guidance_scale=5.0)

            def bidi():
                video = wan.generate(teacher_prompt, seed=7, profile=True)
                return video, None, dict(wan.pipeline.last_profile)

            # every forward: 30 self-attention and 30 cross-attention calls
            out["bidirectional"] = run_teacher(
                "bidirectional_diffusion_1.3b", gen_t, bidi, ("cond", "uncond"),
                steps * 2 * 2 * layers, solver="unipc", steps=steps, guidance=5.0)
            few = BidirectionalInferencePipeline(load_server_config(), gen_t, enc, vae)
            noise = torch.randn(WanT2V.latent_shape((832, 480), 81),
                                generator=torch.Generator(device=dev).manual_seed(8),
                                device=dev).to(torch.bfloat16)

            def few_step():
                video, lat = few.inference(noise, text_prompts=[teacher_prompt],
                                           return_latents=True, seed=8, profile=True)
                return video, lat, dict(few.last_profile)

            n_few = len(few.denoising_step_list)
            out["few_step"] = run_teacher(
                "bidirectional_few_step_1.3b", gen_t, few_step, ("forward",),
                n_few * 2 * layers, steps=list(few.denoising_step_list))
            causal_cfg = load_server_config(num_frame_per_block=3, sample_solver="unipc",
                                            sampling_steps=2, guidance_scale=5.0,
                                            timestep_shift=5.0, context_noise=0)
            causal = CausalDiffusionInferencePipeline(causal_cfg, gen_t, enc, vae)

            def causal_run():
                video, lat = causal.inference(noise, text_prompts=[teacher_prompt],
                                              return_latents=True, profile=True)
                gib = sum(c[k].numel() * c[k].element_size()
                          for c in (causal.kv_cache_pos, causal.kv_cache_neg)
                          for k in ("k", "v")) / 2**30
                return video, lat, dict(causal.last_profile, cache_gib=gib,
                                        cache_tokens=causal.kv_cache_pos["k"].shape[2])

            # 7 blocks of (2 steps x cond and uncond + the refresh of both caches)
            n_causal = 7 * (2 * 2 + 2)
            out["causal"] = run_teacher(
                "causal_diffusion_1.3b", gen_t, causal_run, ("cond", "uncond"),
                n_causal * 2 * layers, solver="unipc", steps_per_block=2, blocks=7,
                decode_forwards=n_causal)
            causal.kv_cache_pos = causal.kv_cache_neg = None
        finally:
            head["w"] = saved
        return out

    tiers, skew_launches, head_w, teacher = {}, {}, None, None
    kernel_paths = {"bf16": ("window", "logit_bound", "block_causal"),
                    "int8": ("window", "logit_bound", "block_causal", "int8_linear", "conv3x3",
                             "conv_quantize")}
    for tier, flags in (("bf16", {}), ("int8", int8_flags)):
        config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                    timestep_shift=5.0, **flags)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models = load(config)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        head_w = random_head(models) if head_w is None else head_w
        launches, plain_on_cuda, peak_gb, stats = serve(
            config, models, t2v_specs((f"{tier}-0", f"{tier}-1")), tier, kernel_paths[tier])
        phase("server", model="t2v-1.3B", tier=tier, load_and_calibrate_s=load_s,
              peak_mem_gib=peak_gb, launches=launches, plain_on_cuda=plain_on_cuda,
              card=card)
        tiers[tier] = dict(launches=launches, stats=stats,
                           x0=block0_x0(config, models, head_w))
        if tier == "bf16":
            # the skewed loops on the same models: RTV_ATTN_SKEW2's switch
            # (K6b), then RTV_ATTN_SKEW's (K6a)
            for switch, key in (("SKEW2", "window_skew_staticmax"), ("SKEW", "window_skew")):
                setattr(hk, switch, True)
                try:
                    got, _, _, _ = serve(config, models, t2v_specs((f"bf16-{switch.lower()}",)),
                                         f"bf16 {switch}", (key, "block_causal"))
                    x0 = block0_x0(config, models, head_w)
                finally:
                    setattr(hk, switch, False)
                cos = cosine(x0, tiers["bf16"]["x0"])
                phase("skew_session", switch=switch, route=key, launches=got,
                      block0_x0_cosine_vs_default=cos, bar=0.999,
                      finite=bool(torch.isfinite(x0).all()), card=card)
                if not (cos > 0.999 and torch.isfinite(x0).all()):
                    fail(f"{switch}: block-0 x0 does not match the default attention: {cos}")
                skew_launches[key] = got[key]
            teacher = teacher_phases(models, head_w)
        del models
        gc.collect()
        torch.cuda.empty_cache()

    corr = cosine(tiers["int8"]["x0"], tiers["bf16"]["x0"])
    finite = bool(torch.isfinite(tiers["int8"]["x0"]).all())
    phase("int8_vs_bf16", block0_x0_corr=corr, bar=0.99, finite=finite)
    if not (corr > 0.99 and finite):
        fail(f"int8 tier's block-0 x0 does not track the bf16 tier's: corr {corr}")

    # -- the int8 tier served with load_all's default text encoder: umT5-xxl --
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = load(int8_config, umt5=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak_umt5 = torch.cuda.max_memory_allocated() / 2**30
    te = models.text_encoder
    if not (isinstance(te, WanTextEncoder) and te.cfg == T5_CONFIGS["umt5-xxl"]):
        fail(f"load_all's default text encoder is not umT5-xxl: {type(te).__name__}")
    ids, mask = te.tokenizer([request["prompt"]])
    ids, mask = torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).to(dev)
    umt5_ms = cuda_ms(lambda: t5_mod.encode_prompts(te.cfg, te.params, ids, mask), 10)
    t5_bytes, t5_ops = t5_work(te.cfg, te.cfg.text_len)
    umt5_bound_ms, umt5_bound_by = bound(t5_bytes, t5_ops, "bf16")
    t5_gib = sum(t.numel() * t.element_size() for t in tensors(te.params)) / 2**30
    phase("umt5_forward", layers=te.cfg.num_layers, dim=te.cfg.dim, vocab=te.cfg.vocab_size,
          length=te.cfg.text_len, tokens=int(mask.sum()), ms=umt5_ms, bound_ms=umt5_bound_ms,
          bound_by=umt5_bound_by, weight_bytes_ms=t5_bytes / HBM_BYTES_PER_S * 1e3,
          tflops=t5_ops / umt5_ms / 1e9, params_gib=t5_gib,
          load_and_calibrate_s=load_s, load_peak_mem_gib=load_peak_umt5,
          library="torch.matmul / torch.softmax (cuBLAS), as the JAX package leaves it to XLA",
          card=card)
    encoder_calls = []

    class CountingEncoder:
        def __call__(self, text_prompts):
            encoder_calls.append(list(text_prompts))
            return te(text_prompts=text_prompts)

    models.text_encoder = CountingEncoder()
    change = {"prompt": "a white owl flying over a pine forest", "interp_steps": 2}
    launches_u, plain_u, peak_u, stats_u = serve(
        int8_config, models, [("int8-umt5-0", request, None), ("int8-umt5-1", request, change)],
        "int8 + umT5", kernel_paths["int8"])
    phase("server", model="t2v-1.3B", tier="int8 + umT5-xxl", peak_mem_gib=peak_u,
          launches=launches_u, plain_on_cuda=plain_u, encoder_calls=encoder_calls,
          ttff_ms_umt5=[s_["ttff_ms"] for s_ in stats_u],
          ttff_ms_static_embedding=[s_["ttff_ms"] for s_ in tiers["int8"]["stats"]],
          fps_warm_umt5=[s_["fps_warm"] for s_ in stats_u],
          fps_warm_static_embedding=[s_["fps_warm"] for s_ in tiers["int8"]["stats"]],
          card=card)
    if encoder_calls != [[request["prompt"]]] * 2 + [[change["prompt"]]]:
        fail(f"umT5 did not encode each session's prompt and the change: {encoder_calls}")

    # webcam: the client pushes seeded 640x480 JPEGs at 24 fps from the request on
    from PIL import Image

    pics = np.random.default_rng(24).random((480, 640, 3))
    jpegs = []
    for i in range(48):
        buf = io.BytesIO()
        Image.fromarray((np.roll(pics, 8 * i, axis=1) * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        jpegs.append(buf.getvalue())
    cam_req = dict(request, webcam_mode=True, strength=0.7)

    async def drive_webcam(sid, fps=24.0):
        runner, base = await start_app(int8_config, models)
        try:
            async with ClientSession() as client:
                async with client.ws_connect(f"{base}/session/{sid}", max_msg_size=0) as ws:
                    if (await ws.receive_json(timeout=60)).get("status") != "ready":
                        fail(f"{sid}: no ready message")
                    encoded.clear()
                    stamps, sizes, pushed = [], [], [0]
                    t_send = time.perf_counter()
                    await ws.send_bytes(packb(cam_req))

                    async def pusher():
                        while True:
                            await ws.send_bytes(packb({
                                "image": jpegs[pushed[0] % len(jpegs)],
                                "strength": cam_req["strength"],
                                "timestamp": time.time() * 1e3}))
                            pushed[0] += 1
                            await asyncio.sleep(max(0.0, t_send + pushed[0] / fps
                                                    - time.perf_counter()))

                    task = asyncio.create_task(pusher())
                    try:
                        final = await receive_all(ws, sid, stamps, sizes)
                    finally:
                        task.cancel()
                    push_s = time.perf_counter() - t_send
                    return (sid, t_send, stamps, sizes, final, list(encoded)), pushed[0], push_s
        finally:
            await runner.cleanup()

    encode_events = []
    real_encode = session_mod.encode_video_latent

    def timed_encode(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_encode(*a, **k)
        end.record()
        encode_events.append((start, end))
        return out

    for m in kernel_mods:
        m.reset_launch_counts()
    session_mod.encode_video_latent = timed_encode
    try:
        cam_session, pushed, push_s = asyncio.run(drive_webcam("webcam-0"))
    finally:
        session_mod.encode_video_latent = real_encode
    torch.cuda.synchronize()
    cam_launches, cam_plain = read_counts()
    encode_block_ms = [a.elapsed_time(b) for a, b in encode_events]
    cam_stats = session_stats("int8 + umT5, webcam", *cam_session, blocks=3,
                              frames_pushed=pushed, push_fps=pushed / push_s,
                              encode_ms_per_block=encode_block_ms)
    phase("webcam_session", frames_in="640x480 JPEG at 24 fps", pushed=pushed,
          push_fps=pushed / push_s, fps_warm=cam_stats["fps_warm"],
          encode_ms_per_block=encode_block_ms, launches=cam_launches,
          plain_on_cuda=cam_plain, card=card)
    missing = [k for k in kernel_paths["int8"] if cam_launches.get(k, 0) <= 0]
    if missing or any(cam_plain.values()) or len(encode_block_ms) != 3:
        fail(f"webcam session: kernels not launched {missing}, plain on CUDA {cam_plain}, "
             f"{len(encode_block_ms)} encodes")
    server_mod.session_frames_storage.clear()
    # the same blocks without the server: each block's frames pushed (and
    # decoded) on this thread first, then the block timed alone between syncs
    direct = GenerationSession(GenerateParams(**cam_req), int8_config, models=models,
                               frame_callback=lambda *a: None)
    direct_ms = []
    for b in range(3):
        for i in range(9 if b == 0 else 12):
            direct.push_frame(jpegs[(12 * b + i) % len(jpegs)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if direct.generate_block_internal(models) is None:
            fail("direct webcam session: a block produced nothing")
        torch.cuda.synchronize()
        direct_ms.append((time.perf_counter() - t0) * 1e3)
    phase("webcam_blocks_without_server", block_ms=direct_ms,
          server_block_ms=cam_stats["block_ms"], card=card)
    del direct

    # a start frame (uploaded, then named by its path), resume latents (.npy
    # bytes) and an input video (uploaded): each takes one block of the budget
    start_buf = io.BytesIO()
    Image.fromarray((pics * 255).astype(np.uint8)).save(start_buf, format="JPEG", quality=90)
    start_path = asyncio.run(upload("/upload_start_frame", start_buf.getvalue(), "start.jpg"))
    npy = io.BytesIO()
    np.save(npy, np.random.default_rng(25).normal(size=(3, 16, 60, 104)).astype(np.float32))
    specs = [("start-frame-0", dict(request, start_frame=start_path), None),
             ("resume-0", dict(request, resume_latents=npy.getvalue()), None)]
    try:
        import cv2

        clip = os.path.join(tempfile.mkdtemp(), "clip.avi")
        writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 16, (640, 480))
        for i in range(33):  # 9 latents: 9 // 3 - 1 = 2 blocks (the reference's arithmetic)
            writer.write((np.roll(pics, 16 * i, axis=0) * 255).astype(np.uint8))
        writer.release()
        with open(clip, "rb") as f:
            video_path = asyncio.run(upload("/upload_video", f.read(), "clip.avi"))
        shutil.rmtree(os.path.dirname(clip))
        specs.append(("input-video-0", dict(request, input_video=video_path, strength=0.7), None))
        v2v_note = "ran"
    except ImportError as e:
        v2v_note = f"not run: cv2 is not installed on this host ({e}); the webcam session ran " \
                   "the same encode-and-mix path"
    ingest_launches, ingest_plain, ingest_peak, ingest_stats = serve(
        int8_config, models, specs, "int8 + umT5, video in", kernel_paths["int8"], blocks=2)
    phase("ingest_sessions", sessions=[s_[0] for s_ in specs], input_video=v2v_note,
          launches=ingest_launches, plain_on_cuda=ingest_plain, peak_mem_gib=ingest_peak,
          card=card)
    session_mod._encode_v2v_cached.cache_clear()  # its key holds these models' VAE
    del models, te
    gc.collect()
    torch.cuda.empty_cache()

    # -- the checkpoint path: the random t2v-1.3B tree as a reference-layout
    # .pt state dict (with the wrapper's "model." prefix), served in the int8
    # tier from checkpoint_path; the same weights through the same kernels
    with tempfile.TemporaryDirectory() as tmp:
        base_dit = WanDiffusion(cfg=WAN_CONFIGS["t2v-1.3B"], device=dev, dtype=torch.bfloat16,
                                seed=0)
        ckpt = os.path.join(tmp, "t2v-1.3B.pt")
        torch.save({f"model.{k}": v for k, v in
                    reference_state_dict(base_dit.params, base_dit.cfg).items()}, ckpt)
        ckpt_gib = os.path.getsize(ckpt) / 2**30
        del base_dit
        ckpt_config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                         timestep_shift=5.0, checkpoint_path=ckpt, **int8_flags)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models = load(ckpt_config)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    launches_ck, plain_ck, peak_ck, _ = serve(ckpt_config, models, t2v_specs(("ckpt-0",)),
                                              "int8 from checkpoint_path", kernel_paths["int8"])
    x0_ck = block0_x0(ckpt_config, models, head_w)
    ck_equal = torch.equal(x0_ck, tiers["int8"]["x0"])
    phase("checkpoint_path", file_gib=ckpt_gib, load_convert_and_calibrate_s=load_s,
          launches=launches_ck, plain_on_cuda=plain_ck, peak_mem_gib=peak_ck,
          block0_x0_bit_equal_to_random_init=ck_equal,
          max_abs_diff=float((x0_ck - tiers["int8"]["x0"]).abs().max()), card=card)
    if not ck_equal:
        fail("the server loaded from checkpoint_path does not reproduce the random-init "
             "server's block-0 latents bit for bit")
    del models
    gc.collect()
    torch.cuda.empty_cache()

    # -- the quantised-tree cache: load_all at 1.3B int8 (with the TAEHV tier)
    # twice with RTV_QUANT_CACHE on in a temporary directory, a miss that
    # builds and stores both trees, then a hit; the trees must be equal bit
    # for bit and stride for stride, and block 0's x0 of a session on each
    def same_tree(a, b, path=""):
        """The first path where two trees differ (structure, dtype, stride,
        bits), or None."""
        if isinstance(a, dict) or isinstance(b, dict):
            if not (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()):
                return path or "/"
            return next((d for k in a if (d := same_tree(a[k], b[k], f"{path}/{k}"))), None)
        if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
            if not (type(a) is type(b) and len(a) == len(b)):
                return path or "/"
            return next((d for i, (x, y) in enumerate(zip(a, b))
                         if (d := same_tree(x, y, f"{path}/{i}"))), None)
        if isinstance(a, torch.Tensor):
            ok = (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                  and a.stride() == b.stride() and torch.equal(a, b))
            return None if ok else path
        return None if a == b else path

    taehv_config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                      timestep_shift=5.0, use_taehv=True, **int8_flags)
    os.environ["RTV_QUANT_CACHE"] = "1"
    try:
        cache_loads, cache_s = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache_loads.append(load(taehv_config))
            torch.cuda.synchronize()
            cache_s.append(time.perf_counter() - t0)
        cache_entries = {f: os.path.getsize(os.path.join(qcache_dir, f)) / 2**30
                         for f in sorted(os.listdir(qcache_dir))}
    finally:
        os.environ["RTV_QUANT_CACHE"] = "0"
        shutil.rmtree(qcache_dir, ignore_errors=True)
        os.makedirs(qcache_dir, exist_ok=True)
    cold, models = cache_loads
    diff_dit = same_tree(cold.transformer.params, models.transformer.params)
    diff_vae = same_tree(cold.vae_decoder.params, models.vae_decoder.params)
    x0_cold = block0_x0(int8_config, cold, head_w)
    del cold, cache_loads
    gc.collect()
    torch.cuda.empty_cache()
    x0_warm = block0_x0(int8_config, models, head_w)
    phase("quant_cache", miss_load_s=cache_s[0], hit_load_s=cache_s[1],
          entries_gib=cache_entries, dit_tree_equal=diff_dit is None,
          vae_tree_equal=diff_vae is None, first_difference=diff_dit or diff_vae,
          block0_x0_bit_equal=torch.equal(x0_cold, x0_warm),
          block0_x0_equal_to_int8_tier=torch.equal(x0_warm, tiers["int8"]["x0"]),
          note="each load is load_all: DiT, VAE, static embedding and TAEHV", card=card)
    if len(cache_entries) != 2 or diff_dit or diff_vae or not torch.equal(x0_cold, x0_warm):
        fail(f"quantised-tree cache: entries {cache_entries}, trees differ at "
             f"{diff_dit or diff_vae}, or block-0 x0 differs")

    # -- the TAEHV preview tier on the hit's models (load_all with use_taehv):
    # two sessions, 9 + 12 + 12 frames, TAEHV's decode timed per block with
    # CUDA events, beside the Wan VAE's int8 sessions above
    taehv_events = []
    taehv_decode = taehv_mod.taehv_decode

    def timed_taehv_decode(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = taehv_decode(*a, **k)
        e1.record()
        taehv_events.append((e0, e1))
        return out

    taehv_mod.taehv_decode = timed_taehv_decode
    try:
        launches_tv, plain_tv, peak_tv, stats_tv = serve(
            taehv_config, models, t2v_specs(("taehv-0", "taehv-1")), "int8 + TAEHV",
            kernel_paths["int8"], first=9)
    finally:
        taehv_mod.taehv_decode = taehv_decode
    torch.cuda.synchronize()
    phase("taehv_sessions", model="t2v-1.3B", tier="int8 + TAEHV", launches=launches_tv,
          plain_on_cuda=plain_tv, peak_mem_gib=peak_tv,
          ttff_ms=[s_["ttff_ms"] for s_ in stats_tv],
          fps_warm=[s_["fps_warm"] for s_ in stats_tv],
          block_ms=[s_["block_ms"] for s_ in stats_tv],
          taehv_decode_ms=[a.elapsed_time(b) for a, b in taehv_events],
          taehv_decode_bound_ms=taehv_bound_ms,
          wan_vae_int8_ttff_ms=[s_["ttff_ms"] for s_ in tiers["int8"]["stats"]],
          wan_vae_int8_fps_warm=[s_["fps_warm"] for s_ in tiers["int8"]["stats"]],
          wan_vae_int8_block_ms=[s_["block_ms"] for s_ in tiers["int8"]["stats"]], card=card)
    if len(taehv_events) != 6:
        fail(f"TAEHV decoded {len(taehv_events)} blocks, expected 6")

    # -- the offline sampler on a fresh pipeline over the same models (its
    # window the global 21 frames, 32760 tokens), the DiT head random as in
    # block0_x0: 21 latents (7 blocks; 4 warped steps and the refresh
    # forward each), decoded to 81 frames; the same call again; an extension
    # from its first 3 latents; the first 9 frames encoded back
    head = models.transformer.params["head"]["head"]
    saved_head, head["w"] = head["w"], head_w.to(head["w"].dtype)
    offline_config = load_server_config(
        model_name="t2v-1.3B", num_frame_per_block=3, timestep_shift=5.0,
        denoising_step_list=[1000, 750, 500, 250], warp_denoising_step=True, context_noise=0,
        **int8_flags)
    pipe = CausalInferencePipeline(offline_config, models.transformer, models.text_encoder,
                                   models.vae_decoder)
    emb = models.text_encoder(text_prompts=[request["prompt"]])["prompt_embeds"]
    noise = torch.randn((1, 21, 16, 60, 104), generator=torch.Generator(device=dev).manual_seed(21),
                        device=dev).to(torch.bfloat16)
    for m in kernel_mods:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    video, lat = pipe.inference(noise, prompt_embeds=emb, return_latents=True, profile=True,
                                seed=5)
    launches_off, plain_off = read_counts()
    peak_off = torch.cuda.max_memory_allocated() / 2**30
    prof_off = dict(pipe.last_profile)
    kv_gib = sum(t.numel() * t.element_size() for t in pipe.kv_cache.values()
                 if isinstance(t, torch.Tensor)) / 2**30
    missing_off = [k for k in ("window", "logit_bound", "int8_linear", "conv3x3", "conv_quantize")
                   if launches_off.get(k, 0) <= 0]
    video2, lat2 = pipe.inference(noise, prompt_embeds=emb, return_latents=True, profile=True,
                                  seed=5)
    prof_off2 = dict(pipe.last_profile)
    rerun_rel, rerun_video_rel = rel_fro(lat2, lat), rel_fro(video2, video)
    video_ext, lat_ext = pipe.inference(noise[:, :6], prompt_embeds=emb,
                                        initial_latent=lat[:, :3], return_latents=True, seed=6)
    z_rt = models.vae_encoder.encode_to_latent(video[:, :9] * 2.0 - 1.0)
    phase("offline_inference", model="t2v-1.3B", tier="int8", latent_frames=lat.shape[1],
          frames=video.shape[1], steps=list(pipe.denoising_step_list),
          refresh_t=pipe.context_noise, max_attention_size=pipe.kv_cache["k"].shape[2],
          init_ms=prof_off["init_ms"], diffusion_ms=prof_off["diffusion_ms"],
          block_ms=prof_off["block_ms"], decode_ms=prof_off["vae_ms"],
          second_call_ms={k: prof_off2[k] for k in ("diffusion_ms", "vae_ms")},
          second_call_block_ms=prof_off2["block_ms"], kv_cache_gib=kv_gib,
          peak_mem_gib=peak_off, launches=launches_off, plain_on_cuda=plain_off,
          rerun_latents_rel_fro=rerun_rel, rerun_video_rel_fro=rerun_video_rel, rerun_bar=1e-3,
          rerun_bit_equal=torch.equal(lat2, lat),
          extension_latents=lat_ext.shape[1], extension_frames=video_ext.shape[1],
          extension_prefix_equal=torch.equal(lat_ext[:, :3], lat[:, :3]),
          round_trip_latents=list(z_rt.shape), card=card)
    if not (tuple(video.shape) == (1, 81, 3, 480, 832) and torch.isfinite(video).all()
            and tuple(lat.shape) == (1, 21, 16, 60, 104)):
        fail(f"offline inference: video {tuple(video.shape)}, latents {tuple(lat.shape)}, "
             f"finite {bool(torch.isfinite(video).all())}")
    if missing_off or any(plain_off.values()):
        fail(f"offline inference: kernels not launched {missing_off}, plain on CUDA {plain_off}")
    if not (rerun_rel < 1e-3 and rerun_video_rel < 1e-3):
        fail(f"offline inference: a second call with the same seed differs: {rerun_rel}")
    if not (lat_ext.shape[1] == 9 and torch.equal(lat_ext[:, :3], lat[:, :3])
            and video_ext.shape[1] == 33 and torch.isfinite(video_ext).all()):
        fail(f"offline extension: latents {tuple(lat_ext.shape)}, frames {video_ext.shape[1]}")
    if not (tuple(z_rt.shape) == (1, 3, 16, 60, 104) and torch.isfinite(z_rt).all()):
        fail(f"encode_to_latent of 9 frames: {tuple(z_rt.shape)}")
    del pipe, video, video2, video_ext, lat2, lat_ext, z_rt
    gc.collect()
    torch.cuda.empty_cache()

    # -- sample_videos (the offline batch API over the session): one prompt,
    # 3 blocks, the Wan VAE's 30 frames, written as mp4 (or .npy)
    sample_dir = tempfile.mkdtemp()
    try:
        for m in kernel_mods:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        vids = sample_mod.sample_videos([request["prompt"]], None, sample_dir,
                                        GenerateParams(**request), models)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        launches_sv, plain_sv = read_counts()
        written = {f: os.path.getsize(os.path.join(sample_dir, f))
                   for f in sorted(os.listdir(sample_dir))}
    finally:
        shutil.rmtree(sample_dir, ignore_errors=True)
        head["w"] = saved_head
    phase("sample_videos", frames=vids[0].shape[0], seconds=sample_s, written=written,
          launches=launches_sv, plain_on_cuda=plain_sv, card=card)
    missing_sv = [k for k in kernel_paths["int8"] if launches_sv.get(k, 0) <= 0]
    if not (vids[0].shape == (30, 3, 480, 832) and np.isfinite(vids[0]).all()
            and len(written) == 1 and next(iter(written)) in ("video_000.mp4", "video_000.npy")):
        fail(f"sample_videos: {vids[0].shape}, files {written}")
    if missing_sv or any(plain_sv.values()):
        fail(f"sample_videos: kernels not launched {missing_sv}, plain on CUDA {plain_sv}")
    del models, vids
    gc.collect()
    torch.cuda.empty_cache()

    def teacher_14b(models, head_w):
        """One UniPC step with CFG (a conditional and an unconditional
        train-mode forward) of the 14B int8 tier over the teacher's 21
        latents (32760 tokens), the head random: with the int8 QK^T attention
        (the 14B set's switch), then with K1 in bf16. The two routes' latents
        and conditional flows must agree (cosine > 0.99, the serving set's
        bar for the same switch)."""
        gen = models.transformer
        layers = gen.cfg.num_layers
        head = gen.params["head"]["head"]
        saved, head["w"] = head["w"], head_w.to(head["w"].dtype)
        enc = SeededTextEncoder(dev, gen.cfg.text_len, gen.cfg.text_dim)
        out, lats = {}, {}
        try:
            cross_c = gen.compute_crossattn_cache(enc([teacher_prompt])["prompt_embeds"])
            cross_u = gen.compute_crossattn_cache(enc([SAMPLE_NEG_PROMPT])["prompt_embeds"])
            noise = torch.randn(WanT2V.latent_shape((832, 480), 81),
                                generator=torch.Generator(device=dev).manual_seed(8),
                                device=dev).to(torch.bfloat16)
            for route, int8qk in (("window_int8qk", True), ("window", False)):
                hk.INT8_QK = int8qk
                gc.collect()
                torch.cuda.empty_cache()
                for m in kernel_mods:
                    m.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                solver = make_solver("unipc", 50, 5.0)  # the first step of the 50
                t_val = float(solver.timesteps[0])
                t = torch.full((1, noise.shape[1]), t_val, dtype=torch.float32, device=dev)
                events, restore = timed_forwards(gen, ("cond", "uncond"))
                t0 = time.perf_counter()
                try:
                    flow_c = gen.forward(noise, cross_c, t, mode="train")[0]
                    flow_u = gen.forward(noise, cross_u, t, mode="train")[0]
                    lat = solver.step(flow_u + 5.0 * (flow_c - flow_u), t_val, noise)
                finally:
                    restore()
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
                launches, plain_on_cuda = read_counts()
                finite = bool(torch.isfinite(lat).all())
                out[route] = dict(forward_ms=forward_ms(events), step_ms=step_ms,
                                  launches=launches,
                                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
                phase("teacher_14b", model="t2v-14B", tier="int8", attention_route=route,
                      latents=list(lat.shape), tokens=noise.shape[1] * 1560, **out[route],
                      plain_on_cuda=plain_on_cuda, finite=finite, card=card)
                want = 2 * 2 * layers  # self and cross in every layer of 2 forwards
                if not finite or launches[route] != want or any(plain_on_cuda.values()):
                    fail(f"teacher_14b ({route}): finite {finite}, launches {launches}, "
                         f"expected {want} on {route}, plain on CUDA {plain_on_cuda}")
                lats[route] = (lat, flow_c)
                del flow_u
        finally:
            head["w"] = saved
        (lat8, flow8), (lat16, flow16) = lats["window_int8qk"], lats["window"]
        cos = dict(latents_cosine=cosine(lat8, lat16), cond_flow_cosine=cosine(flow8, flow16),
                   step_update_cosine=cosine(lat8.float() - noise.float(),
                                             lat16.float() - noise.float()))
        phase("teacher_14b_int8qk_vs_bf16_attention", **cos, bar=0.99,
              held=["latents_cosine", "cond_flow_cosine"])
        if not (cos["latents_cosine"] > 0.99 and cos["cond_flow_cosine"] > 0.99):
            fail(f"teacher_14b: the int8 QK^T step does not track the bf16 attention's: {cos}")
        return out

    # -- t2v-14B in the int8 tier with the int8 QK^T attention on --
    config = load_server_config(model_name="t2v-14B", num_frame_per_block=3,
                                timestep_shift=5.0, **int8_flags)
    plan = serving_memory_plan(WAN_CONFIGS["t2v-14B"], window_frames=6)
    hk.INT8_QK = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        models = load(config)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak_gb = torch.cuda.max_memory_allocated() / 2**30
        path14 = ("window_int8qk", "block_causal_int8qk", "int8_linear", "conv3x3",
                  "conv_quantize")
        launches14, plain14, peak14, stats14 = serve(
            config, models, t2v_specs(("14b-int8qk-0",)), "t2v-14B int8 + int8 QK^T", path14)
        phase("server", model="t2v-14B", tier="int8 + int8 QK^T attention",
              load_and_calibrate_s=load_s, load_peak_mem_gib=load_peak_gb,
              peak_mem_gib=peak14, plan_total_gib=plan.total / 2**30,
              plan=plan.table().splitlines(), launches=launches14, plain_on_cuda=plain14,
              card=card)
        # the TAEHV preview tier on the same models, its params built before
        # the session so that block 0 pays no build
        models.taehv_params = load_taehv(dev)
        taehv14_config = load_server_config(model_name="t2v-14B", num_frame_per_block=3,
                                            timestep_shift=5.0, use_taehv=True, **int8_flags)
        launches14t, plain14t, peak14t, stats14t = serve(
            taehv14_config, models, t2v_specs(("14b-taehv-0",)),
            "t2v-14B int8 + int8 QK^T + TAEHV", path14, first=9)
        phase("taehv_session_14b", launches=launches14t, plain_on_cuda=plain14t,
              peak_mem_gib=peak14t, ttff_ms=stats14t[0]["ttff_ms"],
              fps_warm=stats14t[0]["fps_warm"], block_ms=stats14t[0]["block_ms"],
              wan_vae_int8_ttff_ms=stats14[0]["ttff_ms"],
              wan_vae_int8_fps_warm=stats14[0]["fps_warm"],
              wan_vae_int8_block_ms=stats14[0]["block_ms"], card=card)
        head14 = random_head(models)
        x0_on = block0_x0(config, models, head14)
        hk.INT8_QK = False
        x0_off = block0_x0(config, models, head14)
        teacher14 = teacher_14b(models, head14)
    finally:
        hk.INT8_QK = False
    cos14 = cosine(x0_on, x0_off)
    finite = bool(torch.isfinite(x0_on).all())
    phase("int8qk_vs_bf16_attention_14b", block0_x0_cosine=cos14, bar=0.99, finite=finite)
    if not (cos14 > 0.99 and finite):
        fail(f"14B: block-0 x0 with the int8 QK^T attention does not track the bf16 "
             f"attention's: cosine {cos14}")
    del models
    gc.collect()
    torch.cuda.empty_cache()

    def entry(name, source, replaces, launches, case, max_abs_err, extra=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max_abs_err, "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": case["library_ms"],
                **(extra or {})}

    bf16_l, int8_l = tiers["bf16"]["launches"], tiers["int8"]["launches"]
    sm90_src = "realtime_video_tpu_torch/csrc/attention_sm90.cu"
    conv_src = "realtime_video_tpu_torch/csrc/conv_sm90.cu"
    int8qk_cases = ("int8qk_self_14b", "int8qk_cross_14b", "int8qk_block_causal_14b",
                    "int8qk_shared_offset_14b")
    k3b_cases = ("fc2", "qkv_14b", "fc2_14b", "qkv_14b_teacher", "fc2_14b_teacher",
                 "o_14b_teacher_dynamic")
    k4_cases = ("s8_kt1_c96_480x832", "s8_kt1_c3_480x832", "s8_stride2_c96_480x832")
    k5_cases = ("s8_kt3_c96_480x832", "s8_kt3_c384_60x104", "s8_head_kt3_c96_co3_480x832",
                "s8_first_kt3_c16_co384_60x104", "bf16_kt3_bias_c384_60x104")

    def times(results, case, keys=("ms", "earlier_ms")):
        """{case_key: value} of a case's times, for the kernels line."""
        return {f"{case}_{k}": results[case].get(k) for k in keys}

    kernels = [
        entry("window_attention (K1 static-max; in-kernel running-max fallback)", sm90_src,
              "realtime_video_tpu/ops/pallas_attention.py:220", bf16_l["window"],
              results["self_attn"], max(results["self_attn"]["max_abs_err"],
                                        results["cross_attn"]["max_abs_err"]),
              {"case": "1.3B self-attn; ms the kernel alone", "route_ms":
               results["self_attn"]["route_ms"],
               "earlier_ms": results["self_attn"]["earlier_ms"],
               "earlier_route_ms": results["self_attn"]["earlier_route_ms"],
               "cross_ms": results["cross_attn"]["ms"],
               "cross_route_ms": results["cross_attn"]["route_ms"],
               "cross_earlier_ms": results["cross_attn"]["earlier_ms"],
               "cross_library_ms": results["cross_attn"]["library_ms"],
               "fallback_max_abs_err": results["large_norm"]["max_abs_err"],
               "launches_logit_bound": bf16_l["logit_bound"],
               "launches_int8_path": int8_l["window"],
               "launches_offline_inference": launches_off["window"],
               **{f"teacher_self_32760{sfx}_{k}": teacher_k1[f"teacher_self_32760{sfx}"][k]
                  for sfx in ("", "_14b")
                  for k in ("ms", "route_ms", "plain_ms_rows_1024", "library_ms", "bound_ms",
                            "max_abs_err", "rel_fro_err", "tflops")},
               "launches_teacher_wan_t2v_4_steps": teacher["bidirectional"]["launches"]["window"],
               "launches_teacher_few_step": teacher["few_step"]["launches"]["window"],
               "launches_teacher_causal_diffusion": teacher["causal"]["launches"]["window"],
               "launches_teacher_14b_bf16_cfg_step": teacher14["window"]["launches"]["window"],
               **{f"{c}_{k}": results[c][k]
                  for c in ("offline_window_18720", "offline_window_32760")
                  for k in ("ms", "route_ms", "plain_ms", "library_ms", "bound_ms",
                            "max_abs_err", "rel_fro_err")}}),
        entry("block_causal_attention (K2 running-max flash, block-causal mode)", sm90_src,
              "realtime_video_tpu/ops/pallas_attention.py:97", bf16_l["block_causal"],
              results["block_causal"], results["block_causal"]["max_abs_err"],
              {"case": "1.3B block-causal 9360 / 4680",
               "earlier_ms": results["block_causal"]["earlier_ms"],
               "launches_int8_path": int8_l["block_causal"]}),
        entry("int8qk_attention (K2's int8_qk mode: s8 pre-pass + s8 wgmma QK^T / bf16 PV)",
              sm90_src, "realtime_video_tpu/ops/pallas_attention.py:155",
              launches14["window_int8qk"] + launches14["block_causal_int8qk"],
              mode_results["int8qk_self_14b"],
              max([mode_results[c]["max_abs_err"] for c in int8qk_cases]
                  + [teacher_k1["teacher_self_32760_14b_int8qk"]["max_abs_err"]]),
              {"case": "14B self-attn 4680 / 9360, 40 heads; ms the route (pre-pass + kernel)",
               **{f"teacher_self_32760_14b_{k}": teacher_k1["teacher_self_32760_14b_int8qk"][k]
                  for k in ("ms", "bf16_route_ms", "plain_ms_rows_1024", "library_ms",
                            "bound_ms", "bound_by", "max_abs_err", "rel_fro_err")},
               "earlier_ms": mode_results["int8qk_self_14b"]["earlier_ms"],
               "bf16_route_ms": mode_results["int8qk_self_14b"]["bf16_route_ms"],
               **times(mode_results, "int8qk_cross_14b", ("ms", "earlier_ms", "bf16_route_ms")),
               **times(mode_results, "int8qk_block_causal_14b",
                       ("ms", "earlier_ms", "bf16_route_ms")),
               "launches_window": launches14["window_int8qk"],
               "launches_teacher_14b_cfg_step":
               teacher14["window_int8qk"]["launches"]["window_int8qk"],
               "launches_block_causal": launches14["block_causal_int8qk"],
               "quanta_differing_share": max(mode_results[c]["quanta_differing_share"]
                                             for c in int8qk_cases),
               "library": mode_results["int8qk_self_14b"]["library"]}),
        entry("int8_linear, K-resident form (K3a: K <= 2048)",
              "realtime_video_tpu_torch/csrc/int8_mm.cu",
              "realtime_video_tpu/ops/pallas_int8_mm.py:42",
              int8_l["int8_linear"] - int8_l["int8_linear_k_tiled"], mm_results["qkv"],
              max(mm_results[c]["max_abs_err"] for c in ("qkv", "fc1", "o_dynamic")),
              {"case": "qkv 4680x1536x4608", "earlier_ms": mm_results["qkv"]["earlier_ms"],
               "fc1_ms": mm_results["fc1"]["ms"], "o_ms": mm_results["o_dynamic"]["ms"]}),
        entry("int8_linear, K-tiled form (K3b: K > 2048; every 14B block linear)",
              "realtime_video_tpu_torch/csrc/int8_mm.cu",
              "realtime_video_tpu/ops/pallas_int8_mm.py:62", int8_l["int8_linear_k_tiled"],
              mm_results["fc2"],
              max(mm_results[c]["max_abs_err"] for c in k3b_cases),
              {"case": "fc2 4680x8960x1536", "earlier_ms": mm_results["fc2"]["earlier_ms"],
               **{f"{c}_{k}": mm_results[c][k] for c in k3b_cases[1:]
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
               "launches_14b": launches14["int8_linear_k_tiled"]}),
        entry("conv3x3, 3x3 form (K4: kt 1; s8 with the fused dequantise)", conv_src,
              "realtime_video_tpu/ops/pallas_conv2.py:67",
              int8_l["conv3x3"] - int8_l["conv3x3_temporal"],
              conv_results["s8_kt1_c96_480x832"],
              max(conv_results[c]["max_abs_err"] for c in k4_cases),
              {"case": "s8 kt1 C96 480x832",
               "earlier_ms": conv_results["s8_kt1_c96_480x832"]["earlier_ms"],
               "route_ms": conv_results["s8_kt1_c96_480x832"]["route_ms"],
               "earlier_route_ms": conv_results["s8_kt1_c96_480x832"]["earlier_route_ms"],
               "bf16_cudnn_ms": conv_results["s8_kt1_c96_480x832"]["bf16_cudnn_ms"],
               **times(conv_results, "s8_kt1_c3_480x832"),
               **times(conv_results, "s8_stride2_c96_480x832"),
               "launches_quantize_prepass": int8_l["conv_quantize"],
               "launches_webcam_encode_block0": encode_launches["block0"]["kt1"],
               "launches_webcam_encode_warm_block": encode_launches["warm"]["kt1"],
               "webcam_encoder_forms_held_here": encoder_forms_checked["kt1"]}),
        entry("conv3x3, kt x 3 x 3 form (K5: kt 3, the temporal taps inside)", conv_src,
              "realtime_video_tpu/ops/pallas_conv.py:53", int8_l["conv3x3_temporal"],
              conv_results["s8_kt3_c96_480x832"],
              max(conv_results[c]["max_abs_err"] for c in k5_cases),
              {"case": "s8 kt3 C96 480x832 with the fused dequantise",
               "earlier_ms": conv_results["s8_kt3_c96_480x832"]["earlier_ms"],
               "route_ms": conv_results["s8_kt3_c96_480x832"]["route_ms"],
               "earlier_route_ms": conv_results["s8_kt3_c96_480x832"]["earlier_route_ms"],
               "bf16_cudnn_ms": conv_results["s8_kt3_c96_480x832"]["bf16_cudnn_ms"],
               **times(conv_results, "s8_kt3_c384_60x104"),
               **times(conv_results, "s8_head_kt3_c96_co3_480x832"),
               **times(conv_results, "s8_first_kt3_c16_co384_60x104"),
               **times(conv_results, "bf16_kt3_bias_c384_60x104",
                       ("ms", "earlier_ms", "library_ms")),
               "launches_webcam_encode_block0": encode_launches["block0"]["kt3"],
               "launches_webcam_encode_warm_block": encode_launches["warm"]["kt3"],
               "webcam_encoder_forms_held_here": encoder_forms_checked["kt3"]}),
        entry("skew_attention (K6a: the sm90 kernel's running max, QK^T(j) with PV(j-1))",
              sm90_src, "realtime_video_tpu/ops/pallas_attention.py:445",
              skew_launches["window_skew"], mode_results["skew_self"],
              mode_results["skew_self"]["max_abs_err"],
              {"case": "1.3B self-attn", "earlier_ms": mode_results["skew_self"]["earlier_ms"]}),
        entry("skew_staticmax_attention (K6b: the sm90 kernel's static max; running-max "
              "fallback)", sm90_src, "realtime_video_tpu/ops/pallas_attention.py:323",
              skew_launches["window_skew_staticmax"], mode_results["skew_staticmax_self"],
              mode_results["skew_staticmax_self"]["max_abs_err"],
              {"case": "1.3B self-attn; ms the route (bound pre-pass + kernel)",
               "earlier_ms": mode_results["skew_staticmax_self"]["earlier_ms"],
               "fallback_max_abs_err":
               mode_results["skew_staticmax_large_norm"]["max_abs_err"]}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
