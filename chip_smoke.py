"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 for the numbers in PERF.md).

    python3 chip_smoke.py
    python3 chip_smoke.py --vae-phases [split] [fuseup] [multi_gpu]   (those alone)
    python3 chip_smoke.py --session-phases   (session_megafuse alone, bf16 then int8)
    python3 chip_smoke.py --dit-norm-phases   (phase 2's DiT norm entries alone)

Phases, each reported on its own lines:
  1. device: the card's name and power limit (nvidia-smi), the build of the
     four hand-written kernel libraries from realtime_video_tpu_torch/csrc/
     (one nvcc per source, all started together; with the earlier kernels'
     sources under _archive/, those too, for the A/B times below), and, per
     library, its counts of HGMMA / IGMMA (wgmma), UTMALDG (TMA load) and
     HMMA (mma.sync) instructions in `cuobjdump -sass`: every library must
     show wgmma, the wgmma/TMA ones TMA loads, and the attention backward no
     mma.sync; and ptxas's registers and spills of the backward's kernels
     (`-Xptxas=-v`), which must spill nothing;
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
       - the DiT's norm row kernels (csrc/dit_norm_sm90.cu, `dit_norm_phase`)
         at each site of a layer, L 4680 in 3 frames at D 1536 and 5120 (q
         and k read out of the [L, 3D] qkv output): against the plain chains
         of models/wan_dit.py, at most 1 bf16 ulp and 99.9% of elements
         bit-equal; their time beside the bytes bound and the plain chain's;
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
     width with 2 layers on 3 latent frames at 832x480 the same way; then
     the training path (`backward_kernel_phase`, `training_phase`): the
     attention backward (csrc/attention_bwd_sm90.cu: wgmma, TMA, warp
     specialisation) against its plain version at the training shapes, two
     large-norm windows and the two again with near-parallel keys
     (BWD_CASES), its dq, dk and dv each under `agreement` at `grad_atol`
     (dq at near-parallel keys at bars set from SDPA flash's error there),
     bit-equal over two launches, the forward's LSE against the plain one,
     timed beside its bound, torch SDPA's backward and (with _archive/) its
     first form, with the D term dropped, the window 16 short and a 1%
     scale error as planted faults; DMD's generator gradient of
     2-layer t2v-1.3B-width networks on the card in bf16 against the CPU's
     f32 (cosine, norm ratio and relative error, the CPU's bf16 run beside
     as the control); and train.py's path at
     t2v-1.3B full width (`train.build` / `train_step`: three networks from
     seeds 0 / 1 / 2, random heads, 6 latent frames of 60x104): two DMD
     steps and one causal flow-matching step, each with its ms, peak GiB,
     losses and gradient norms (finite, nonzero), the params moved, the
     backward launches equal to what the code implies, none plain; then GAN
     distillation (`gan_phases`): the generator and critic losses (with a
     real latent, R1 and R2, relativistic off and on) of 2-layer
     t2v-1.3B-width networks, card against the CPU's f32 at DMD's bars, and
     at train.py's full shape two generator and two critic updates with the
     GAN head (taps 13 / 21 / 29), their ms, peak GiB, finite nonzero losses
     and gradient norms (the head's too) and exactly the K1 and backward
     launches the code implies; the register token's attention (Lq 1 over
     9360 keys) in torch ops beside K1's route, for the record; then the
     ODE-pair path (`ode_pairs_phase`): `generate_ode_pairs` on t2v-1.3B at
     21 latents of 832x480 (2 prompts, 4 steps in place of 48), its shard
     through `create_shards` and read back bit for bit, and one
     `ode_regression_loss` update on the trajectory; then teacher forcing:
     mode 2 of both attention kernels at train.py's shape, 2L = 18720 in
     blocks of 4680, 12 heads (`teacher_forcing_kernel`: the forward on four
     row slices and the backward on the whole call against their plain
     versions, four planted faults, times beside the bounds and torch SDPA
     under the dense mask), and `dit_forward(tf_concat=True)` at t2v-1.3B
     (`teacher_forcing_1p3b`: forward and forward + backward ms and peak
     GiB, the launches as derived, JAX's causality test at full width);
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
         attention's (cosine > 0.999); then `session_megafuse`
         (`session_megafuse_phase`: the session's throughput mode,
         RTV_SESSION_MEGAFUSE, against the switch at 0 over four 5-block
         sessions, latents and frames bit-equal, their TTFF, block walls
         and host-queue against device time; a warm block under
         `torch.cuda.set_sync_debug_mode("error")`, and the same block with
         the former host-built formulas planted back, which must raise
         there and be counted under "warn": `planted_sync`); then the
         teacher path
         on the same models (the teacher's precision, a random head, prompts from
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
         output is not zero; then `session_megafuse` on its models, its
         sync check also for TAEHV and a 2-shard VAE on this card; then the
         VAE's placement (`vae_phases`): `device_guard` (the bindings' device guard's host
         cost a block), `vae_split_one_card` (the VAE in bf16 and int8
         split by rows into 2 and 4 shards on this card against the
         unsplit one, K4/K5 at every shard form against the plain version,
         interior halos zeroed as the planted fault, a 3-block session with
         a 2-shard VAE; `vae_split_op_divergence`: each op of a bf16 split
         decode on its own inputs, where only cuDNN's convs may differ, each
         within the per-conv bar), `vae_split_conv_bf16` (the split's bf16
         convs one at a time, warm and first chunks, and their no-halo
         fault), `vae_fuseup` (the phase-folded decode in bf16 and
         int8 against the unfused one, the fused convs' forms at 4x the
         output channels, both timed in turns) and `vae_multi_gpu` (a VAE
         pinned to cuda:1, and split over cuda:1..N-1, against one card,
         each layout's sessions timed in both session modes; `{"ran":
         false}` on one card);
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
         latents and conditional flows at cosine > 0.99;
       - the server warm-up (`server_warmup_phase`): two fresh server
         processes at 1.3B int8, without and with DO_COMPILE=1, each's
         warm-up record (library builds, seconds per shape) and first
         session's TTFF at the client; the warm-up must run under DO_COMPILE
         and not without it;
       - the real-checkpoint path (`real_checkpoint_phase`), last: a
         full-size checkpoint set synthesised in the reference's layout
         (1.3B DiT, Wan 2.1 VAE, umT5-xxl) in a temporary MODEL_FOLDER, each
         file's converter round trip bit for bit, `run_real_checkpoint` in a
         subprocess (30 finite frames, a checksum, load seconds by file), and
         `sweep_sample` over two DiTs against a direct `sample_videos`.
  5. the multi-GPU phases (`parallel_phases`,
     realtime_video_tpu_torch/tools/parallel_smoke.py), after the card's
     compute mode is read (an exclusive mode fails): tp and dp x tp run as
     ranks that share this card over gloo (`parallel/launch.run`; gloo's
     CUDA all-reduce is probed and printed), each against the same work in
     this process from the same seeds, their walls printed as those of
     ranks sharing one card:
       - `tp_denoise_1p3b`: t2v-1.3B, 30 layers, tp 2 (6 heads a rank), bf16
         and int8 with static scales: reset, prefill and a 4-step block at
         832x480 with 3 KV frames; x0 against one process (cosine and
         relative Frobenius, `TP_*_BAR`), bit-identical over the ranks, each
         rank's K1 / K2 / K3 / bound pre-pass launches equal to the
         derivation;
       - `tp_forward_14b`: t2v-14B int8 (dynamic scales) with the int8 QK^T
         attention, 2 layers, tp 4 (10 heads a rank): a decode forward
         against one process; on each rank's own shards, timed one rank at
         a time, K3 at qkv 4680x5120x3840 and fc2 4680x3456x5120 within 1
         bf16 ulp and K2-int8 at 10 heads, each beside its bound;
       - `dp_tp_train_step`: dp 2 x tp 2, t2v-1.3B width, 2 layers, a batch
         of 2 at train.py's latent shape: one flow-matching step with the
         EMA against the one-process step: the averaged gradient, the AdamW
         update and the EMA shadow's step each by cosine and relative error
         (`TRAIN_BARS`), a planted fault (the dp mean of the gradients
         dropped) caught by the same bars, replicated leaves bit-equal over
         tp, the backward launches;
       - `ring_kernel_composition` (one process): rank 0's query shard of
         the teacher's 32760² unmasked self-attention at 12 and 40 heads,
         sp 2 / 4 / 8: K1 with its LSE over each key shard, merged, against
         one K1 launch over all keys (`agreement`, the LSE within 2e-3),
         timed beside the single launch and the bound;
       - `nccl_multi_gpu`: with two or more cards, tp over NCCL and the
         1.3B teacher forward with `sp_mesh` at sp = the card count against
         one card; on one card `{"ran": false}`.
The quantised-tree cache is off (RTV_QUANT_CACHE=0) outside its phase, and
its directory is a temporary one, removed at exit.

Before its last line it prints the kernels' JSON summary, one row per TPU
kernel of the repo (nine rows, each with `earlier_ms`: the replaced
version's time in this run where _archive/ holds it, else null), one for
the attention backward, which replaces no TPU kernel (its `earlier_ms` the
first, mma.sync form's), and one for the teacher-forcing mode of the two
attention kernels, which replaces none either; the
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
import contextlib
import ctypes
import dataclasses
import faulthandler
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import socket
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
#: the attention backward's first form (mma.sync, cp.async), for its A/B
BWD_EARLIER = ARCHIVE / "attention_bwd_sm90_earlier.cu"


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
    """Counts of wgmma (HGMMA bf16, IGMMA s8), TMA load (UTMALDG) and
    mma.sync (HMMA) instructions in a library's SASS."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "IGMMA", "UTMALDG", "HMMA")}


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
    """Cosine similarity, in f64 whatever the inputs' dtype (an f32 dot
    product over the ~10^8 elements of a model's gradient can pass 1)."""
    a, b = a.flatten().double(), b.flatten().double()
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


def event_ms(fn, n: int) -> float:
    """Mean CUDA-event time of fn over n calls, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


#: the attention backward's cases at the training shapes (t2v-1.3B, 12 heads,
#: 6 latent frames of 60x104: 1560 tokens a frame, blocks of 4680): the
#: rollout's decode windows (block 1 over both blocks, block 0 over itself),
#: the critic's unmasked fake-score forward, the flow-matching step's
#: block-causal forward, and the cross-attention over 512 text tokens; then
#: the decode window on large-norm q and k, as the forward's large-norm
#: case: at norm 1.5 the bound stays under STATIC_MAX_LIMIT (the static
#: max, several times the true row maxima: a tiny row sum), at 3.0 it
#: passes it (the running-max fallback, on logits several times larger);
#: and both again with near-parallel keys, k = [q; 0.97 q], where dq is held
#: at `NEAR_PARALLEL_DQ_*` (bf16's own error there: see hopper_attention);
#: (name, mode, lq, lk, lo, hi or block_tokens, norm, near-parallel keys)
BWD_CASES = (
    ("decode_4680x9360", "window", 4680, 9360, 0, 9360, 1.0, False),
    ("decode_4680x4680", "window", 4680, 4680, 0, 4680, 1.0, False),
    ("unmasked_9360", "window", 9360, 9360, 0, 9360, 1.0, False),
    ("block_causal_9360_4680", "block_causal", 9360, 9360, 0, 4680, 1.0, False),
    ("cross_9360x512", "window", 9360, 512, 0, 512, 1.0, False),
    ("large_norm_static_4680x9360", "window", 4680, 9360, 0, 9360, 1.5, False),
    ("large_norm_fallback_4680x9360", "window", 4680, 9360, 0, 9360, 3.0, False),
    ("near_parallel_static_4680x9360", "window", 4680, 9360, 0, 9360, 1.5, True),
    ("near_parallel_fallback_4680x9360", "window", 4680, 9360, 0, 9360, 3.0, True),
)


def load_earlier_backward(libs: dict):
    """The attention backward's first form (mma.sync, cp.async), bound as its
    source declares it, or None without _archive/."""
    if BWD_EARLIER not in libs:
        return None
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(libs[BWD_EARLIER]))
    lib.rtv_attention_bwd_sm90.argtypes = [p] * 11 + [i] * 5 + [f] + [i] * 8 + [p]
    lib.rtv_attention_bwd_sm90.restype = i
    return lib


def backward_kernel_phase(card: str, dev, earlier=None) -> dict:
    """csrc/attention_bwd_sm90.cu against its plain version at BWD_CASES:
    dq / dk / dv each under `hopper_attention.agreement` at `grad_atol` (dq
    of the near-parallel cases at `near_parallel_dq_agreement`). The kernel
    takes the output and LSE of the forward kernel as the training path calls
    it (the window with the static max after the bound pre-pass, or its
    fallback; block-causal with the running max); the plain side is
    `kernel_backward_plain`, the plain backward of the function the kernels
    compute (q prescaled by bf16(scale * log2 e)) on the plain forward's own
    LSE, so a kernel that differentiates another scale, or trusts a wrong
    LSE, fails. The forward's LSE against that plain one (2e-3). Two
    launches on the same inputs must give bit-equal dq, dk and dv. Timed
    with CUDA events: the backward (its pre-pass, dQ and dK/dV passes), in
    turns with its first form from _archive/ where present (earlier, new,
    new, earlier: `earlier_ms`), its dQ pass alone (the cross-attention's
    form on the generator path), the plain version, and torch SDPA's
    backward on the same q, k, v and dO (flash on the window's live keys;
    the efficient kernel under the boolean block-causal mask). On the
    near-parallel cases SDPA flash's backward also runs the kernels'
    function (prescaled q at scale 1 / log2 e) and its dq, dk, dv are held
    against the plain backward on its own output: the error bf16 gives
    there, which the dq bar rests on. Planted faults: the D term dropped,
    the window's hi 16 short (unit-norm windows), and on the large-norm
    cases the backward at a softmax scale 1% below the forward's (its c one
    bf16 step lower, 1.5%)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from realtime_video_tpu_torch.ops import hopper_attention as hk

    heads, hd = 12, 128
    scale = hd ** -0.5
    gen = torch.Generator(device=dev).manual_seed(10)

    def rnd(shape, norm=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * norm).to(torch.bfloat16)

    def earlier_backward(q, k, v, out, do, lse, mask):
        """dq, dk, dv by the first form (its D scratch [B, N, Lq])."""
        b, lq, n, d = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
        qc = torch.empty_like(q)
        err = earlier.rtv_attention_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), qc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, lq, k.shape[1], n, d, hk.qscale(scale), *mask.kernel_args(), 1, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the earlier attention backward launch failed: cudaError {err}")
        return dq, dk, dv

    def sdpa(qt, kt, vt, lib_mask, sc):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask, scale=sc)

    results = {}
    for name, mode, lq, lk, lo, arg, norm, near_parallel in BWD_CASES:
        q = rnd((1, lq, heads, hd), norm)
        if near_parallel:  # keys q and 0.97 q
            k = torch.cat([q, (q.float() * 0.97).to(torch.bfloat16)], 1)
        else:
            k = rnd((1, lk, heads, hd), norm)
        v, do = rnd((1, lk, heads, hd)), rnd((1, lq, heads, hd))
        window = mode == "window"
        mask = hk.Mask.window(lo, arg) if window else hk.Mask.block_causal(lk, arg)
        m_bound = None
        if norm != 1.0:
            m_bound = float(hk.logit_bound_plain(q, k, scale)[0])
            if (m_bound < hk.STATIC_MAX_LIMIT) != ("_static_" in name):
                fail(f"attention backward {name}: the logit bound {m_bound} does not reach "
                     f"the forward's intended max (limit {hk.STATIC_MAX_LIMIT})")
        maxima = hk.logit_bound_maxima(q, k, scale) if window else None
        out, lse = hk._launch_sm90(q, k, v, scale, maxima, *mask.kernel_args(), with_lse=True)
        _, lse_plain = hk.attention_forward_plain(hk.prescale(q, scale), k, v, mask,
                                                  1.0 / hk.LOG2E)
        lse_err = (lse - lse_plain).abs().max().item()
        del lse_plain
        kern = lambda: hk.attention_backward(q, k, v, out, do, lse, scale, mask)  # noqa: E731
        plain = lambda: hk.kernel_backward_plain(q, k, v, out, do, scale, mask)  # noqa: E731
        got, want = kern(), plain()
        again = kern()
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        del again

        def check(grads, ref):
            return {g: (hk.near_parallel_dq_agreement(a, b) if near_parallel and g == "dq"
                        else hk.agreement(a, b, hk.grad_atol(b)))
                    for g, a, b in zip(("dq", "dk", "dv"), grads, ref)}

        res = check(got, want)
        extra = {}
        if earlier is not None:
            res_e = check(earlier_backward(q, k, v, out, do, lse, mask), want)
            extra["earlier_errors"] = {g: {key: r[key] for key in ("max_abs_err", "rel_fro_err",
                                                                   "within_tol")}
                                       for g, r in res_e.items()}
        faults = {"drop_D": lambda: hk.attention_backward(q, k, v, out, do, lse, scale, mask,
                                                          fault=hk.FAULT_DROP_D)}
        if window and norm == 1.0:
            faults["hi-16"] = lambda: hk.attention_backward(
                q, k, v, out, do, lse, scale, hk.Mask.window(lo, arg - 16))
        if norm != 1.0:  # a backward at another softmax scale than the forward's
            faults["scale-1%"] = lambda: hk.attention_backward(q, k, v, out, do, lse,
                                                               scale * 0.99, mask)
        caught = {}
        for fault, fn in faults.items():
            caught[fault] = any(not r["within_tol"] for r in check(fn(), want).values())
        del got, want
        if earlier is not None:
            e_kern = lambda: earlier_backward(q, k, v, out, do, lse, mask)  # noqa: E731
            t = [event_ms(e_kern, 10), event_ms(kern, 10), event_ms(kern, 10),
                 event_ms(e_kern, 10)]
            ms, earlier_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        else:
            ms, earlier_ms = event_ms(kern, 10), None
        dq_ms = event_ms(lambda: hk.attention_backward(q, k, v, out, do, lse, scale, mask,
                                                       need_kv=False), 10)
        fwd_ms = event_ms(lambda: hk._launch_sm90(q, k, v, scale, maxima, *mask.kernel_args(),
                                                  with_lse=True), 10)
        plain_ms = event_ms(lambda: hk.attention_backward_plain(q, k, v, out, do, lse, scale,
                                                                mask), 1)
        # torch SDPA's backward on the same inputs, the yardstick
        if window:
            ks, vs, lib_mask = k[:, lo:arg], v[:, lo:arg], None
            backends = [SDPBackend.FLASH_ATTENTION]
        else:
            ks, vs, lib_mask = k, v, mask.dense(lq, lk, dev)
            backends = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]
        library_ms, library = None, None
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, ks, vs))
        g = do.transpose(1, 2)
        for backend in backends:
            try:
                with sdpa_kernel([backend]):
                    o = sdpa(qt, kt, vt, lib_mask, scale)
                    library_ms = event_ms(lambda: torch.autograd.grad(
                        o, (qt, kt, vt), g, retain_graph=True), 10)
                library = f"torch SDPA {backend.name} backward"
                break
            except RuntimeError:
                continue
        if near_parallel:  # SDPA flash's backward of the kernels' function, and its error
            qc = hk.prescale(q, scale).transpose(1, 2).detach().requires_grad_()
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                o = sdpa(qc, kt, vt, None, 1.0 / hk.LOG2E)
                dqc, dks, dvs = torch.autograd.grad(o, (qc, kt, vt), g)
            c = hk.qscale(scale)
            lib_grads = ((dqc.float() * c).to(q.dtype).transpose(1, 2), dks.transpose(1, 2),
                         dvs.transpose(1, 2))
            want_lib = hk.kernel_backward_plain(q, k, v, o.detach().transpose(1, 2).contiguous(),
                                                do, scale, mask)
            extra["library_errors"] = {
                name_: {"max_abs_err_of_max": r["max_abs_err"] / w.float().abs().max().item(),
                        "rel_fro_err": r["rel_fro_err"]}
                for name_, r, w in zip(("dq", "dk", "dv"),
                                       (hk.agreement(a, b) for a, b in zip(lib_grads, want_lib)),
                                       want_lib)}
            extra["dq_bar"] = {"rel_fro": hk.NEAR_PARALLEL_DQ_REL_FRO,
                               "atol_of_max": hk.NEAR_PARALLEL_DQ_ATOL}
            del qc, o, dqc, dks, dvs, lib_grads, want_lib
        del qt, kt, vt, lib_mask
        fwd_flop = (hk.window_flops(lq, lo, arg, heads, hd) if window
                    else hk.block_causal_flops(lq, arg, heads, hd))
        flop = 2.5 * fwd_flop  # 5 products against the forward's 2
        live_k = (arg - lo) if window else lk
        io_bytes = 2.0 * heads * hd * (4 * lq + 4 * live_k) + 4.0 * heads * lq
        bound_ms, bound_by = bound(io_bytes, flop, "bf16")
        results[name] = dict(
            ms=ms, earlier_ms=earlier_ms, dq_pass_ms=dq_ms, forward_with_lse_ms=fwd_ms,
            plain_ms=plain_ms, library_ms=library_ms, library=library, bound_ms=bound_ms,
            bound_by=bound_by, tflops=flop / ms / 1e9, lse_max_abs_err=lse_err, norm=norm,
            near_parallel_keys=near_parallel, logit_bound=m_bound,
            max_abs_err=max(r["max_abs_err"] for r in res.values()),
            rel_fro_err=max(r["rel_fro_err"] for r in res.values()),
            **{f"{g}_{key}": r[key] for g, r in res.items()
               for key in ("max_abs_err", "rel_fro_err", "atol")},
            deterministic=deterministic, faults_caught=caught, **extra)
        phase("kernel", kernel="attention_backward", case=name, mode=mode, lq=lq, lk=lk, lo=lo,
              arg=arg, heads=heads, head_dim=hd, **results[name], card=card)
        if not all(r["within_tol"] for r in res.values()):
            fail(f"attention backward {name}: kernel outside the bounds of the plain "
                 f"version: {res}")
        if lse_err > 2e-3:
            fail(f"attention backward {name}: the forward's LSE is {lse_err} off the plain one")
        if not all(caught.values()):
            fail(f"attention backward {name}: a planted fault passes the check: {caught}")
        if not deterministic:
            fail(f"attention backward {name}: two launches on the same inputs differ")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return results


class RecordingDraws:
    """`TorchDraws` that keeps every draw, for a replay on the CPU."""

    def __init__(self, draws):
        self.draws, self.items = draws, []

    def normal(self, shape, dtype, device):
        out = self.draws.normal(shape, dtype, device)
        self.items.append(out.float().cpu())
        return out

    def randint(self, low, high, shape):
        out = self.draws.randint(low, high, shape)
        self.items.append(out)
        return out


class ReplayDraws:
    """The recorded draws, in order."""

    def __init__(self, items):
        self.items = list(items)

    def normal(self, shape, dtype, device):
        return self.items.pop(0).to(device=device, dtype=dtype)

    def randint(self, low, high, shape):
        return self.items.pop(0)


#: the 2-layer generator gradient, card (bf16) against the CPU's f32: the
#: cosine, |g_card| / |g_cpu| - 1 and |g_card - g_cpu| / |g_cpu|. A sound
#: run reads 0.999987 / -3.5e-4 / 5.1e-3 (H100 80GB HBM3, 700 W); the CPU's
#: own bf16 run, the control printed beside, reads 0.999989 / -6.6e-4 /
#: 4.7e-3. The bars sit 4x and more past both, and a backward that scales
#: every gradient by 1-2% fails the ratio and the relative error.
GRAD_COSINE_BAR, GRAD_NORM_RATIO_BAR, GRAD_REL_FRO_BAR = 0.999, 1e-2, 2e-2


def training_phase(card: str, dev, read_counts, kernel_mods, latent=(60, 104)) -> dict:
    """The distillation path on the card.

    First DMD's generator loss of 2-layer t2v-1.3B-width networks (6 latent
    frames of 16x16) on the card in bf16 against the CPU's f32 on the same
    weights and the card's draws replayed: the loss and the gradient, whose
    cosine over every leaf must pass 0.99. Then train.py's path at full width
    (`train.build` / `train.train_step`: three t2v-1.3B networks in bf16 from
    seeds 0 / 1 / 2 with random heads, a seeded static text embedding, 6
    latent frames of 60x104, steps 1000 / 750 / 500 / 250, guidance 3, every
    DiT layer under checkpointing): two DMD generator + critic steps, then one
    causal flow-matching step (`make_train_step`) on the generator; each
    step's ms, peak GiB, losses and gradient norms (finite and nonzero), the
    params moved, the launch counts against what the code implies, and no
    plain version on a CUDA tensor."""
    import torch

    from realtime_video_tpu_torch import train as train_mod
    from realtime_video_tpu_torch.config import WAN_CONFIGS, load_server_config
    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
    from realtime_video_tpu_torch.training import distillation, losses, train_step
    from realtime_video_tpu_torch.training.draws import TorchDraws

    out = {}
    # -- a 2-layer full-width generator-loss gradient, card against CPU --
    two = dataclasses.replace(WAN_CONFIGS["t2v-1.3B"], num_layers=2)
    config = load_server_config(denoising_step_list=[1000, 750, 500, 250], guidance_scale=3.0)
    sides = {"gpu": (dev, torch.bfloat16), "cpu": ("cpu", torch.float32),
             "cpu_bf16": ("cpu", torch.bfloat16)}
    nets = {side: [] for side in sides}
    for s in range(3):
        p = wan_dit.init_wan_params(two, torch.Generator().manual_seed(s), "cpu",
                                    torch.bfloat16)
        p["head"]["head"]["w"] = (torch.randn(p["head"]["head"]["w"].shape,
                                              generator=torch.Generator().manual_seed(20 + s))
                                  * 0.05).to(torch.bfloat16)
        for side, (device, dtype) in sides.items():
            nets[side].append(WanDiffusion(cfg=two, params=tree_to(p, device, dtype),
                                           fuse_qkv=False))
    ctx = torch.randn((1, 512, two.text_dim), generator=torch.Generator().manual_seed(3))
    noise = torch.randn((1, 6, 16, 16, 16), generator=torch.Generator().manual_seed(4))
    record = None
    grads, loss_of = {}, {}
    for side, (device, dtype) in sides.items():
        g, r, f = nets[side]
        with torch.no_grad():
            cross = g.compute_crossattn_cache(ctx.to(device, dtype))
            cross_u = g.compute_crossattn_cache(-ctx.to(device, dtype))
        dmd = distillation.DMD(g, r, f, config)
        params = losses.trainable(g.params)
        draws = (RecordingDraws(TorchDraws(5, dev)) if side == "gpu"
                 else ReplayDraws(record))
        loss, _ = dmd.generator_loss(params, f.params, noise.to(device, dtype), cross, cross_u,
                                     draws)
        loss.backward()
        if side == "gpu":
            record = draws.items
        loss_of[side] = float(loss.detach())
        grads[side] = torch.cat([t.grad.double().cpu().flatten()
                                 for t in losses.tree_leaves(params).values()
                                 if t.grad is not None])

    def against_f32(side):
        """(cosine, norm ratio, relative Frobenius error) of a side's gradient
        against the CPU's f32 one."""
        got, want = grads[side], grads["cpu"]
        return (cosine(got, want), float(got.norm() / want.norm()),
                float((got - want).norm() / want.norm()))

    cos, ratio, rel_fro = against_f32("gpu")
    c_cos, c_ratio, c_rel_fro = against_f32("cpu_bf16")
    rel_loss = abs(loss_of["gpu"] - loss_of["cpu"]) / abs(loss_of["cpu"])
    out["grad_card_vs_cpu"] = dict(
        layers=2, dim=two.dim, heads=two.num_heads, latents=[6, 16, 16],
        loss_card=loss_of["gpu"], loss_cpu=loss_of["cpu"], loss_rel_err=rel_loss,
        grad_cosine=cos, grad_norm_ratio=ratio, grad_rel_fro=rel_fro,
        grad_norm_card=float(grads["gpu"].norm()), grad_norm_cpu=float(grads["cpu"].norm()),
        control_cpu_bf16=dict(loss=loss_of["cpu_bf16"], grad_cosine=c_cos,
                              grad_norm_ratio=c_ratio, grad_rel_fro=c_rel_fro),
        bars=dict(grad_cosine=GRAD_COSINE_BAR, norm_ratio=GRAD_NORM_RATIO_BAR,
                  rel_fro=GRAD_REL_FRO_BAR, loss_rel_err=5e-2))
    phase("dmd_generator_grad_2layer_card_vs_cpu", **out["grad_card_vs_cpu"], card=card)
    if not (cos > GRAD_COSINE_BAR and abs(ratio - 1) < GRAD_NORM_RATIO_BAR
            and rel_fro < GRAD_REL_FRO_BAR and rel_loss < 5e-2
            and torch.isfinite(grads["gpu"]).all()):
        fail(f"the generator loss's gradient on the card disagrees with the CPU's: "
             f"{out['grad_card_vs_cpu']}")
    del nets, grads, record
    gc.collect()
    torch.cuda.empty_cache()

    # -- train.py's path at t2v-1.3B full width --
    args = train_mod.parse_args([
        "--config", train_mod.TRAIN_CONFIG, "--text-encoder", "seeded",
        "--lr", "1e-4", "--critic-lr", "1e-4", "--steps", "2",
        "--latent", str(latent[0]), str(latent[1]), "--device", str(dev)])
    t0 = time.perf_counter()
    tr = train_mod.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = tr.model.generator.cfg
    watch = {"generator": losses.tree_leaves(tr.gen_params),
             "fake_score": losses.tree_leaves(tr.fake_params)}
    before = {net: {k: watch[net][k].detach().clone() for k in
                    ("blocks/self_attn/q/w", "blocks/ffn/fc2/w", "head/head/w")}
              for net in watch}
    for m in kernel_mods:
        m.reset_launch_counts()
    steps = []
    for step in range(2):
        rec = train_mod.train_step(tr, step)
        steps.append(rec)
        phase("train_step_dmd", model="t2v-1.3B", tier="bf16", latents=[6, *latent],
              **rec, card=card)
    launches_dmd, plain_dmd = read_counts()
    moved = {net: {k: bool((watch[net][k].detach() != v).any()) for k, v in leaves.items()}
             for net, leaves in before.items()}
    nl, nb = cfg.num_layers, 2
    # generator step: the two blocks' chosen steps (every layer) and block 0's
    # refresh, whose K/V reach block 1 from every layer but whose last layer's
    # attention outputs reach nothing; critic step: the fake score's forward
    gen_bwd = nb * nl + (nb - 1) * (nl - 1)
    want_dmd = {"window_bwd": 2 * (2 * gen_bwd + 2 * nl), "block_causal_bwd": 0}
    # the flow-matching step on the generator (its own AdamW)
    _, opt = train_step.make_train_state(tr.model.generator, learning_rate=1e-4)
    fm_step = train_step.make_train_step(tr.model.generator, opt)
    draws = TorchDraws(11, dev)
    lat = draws.normal((1, 6, cfg.in_dim, *latent), torch.bfloat16, dev)
    emb = tr.text_encoder(["a cat surfing"])["prompt_embeds"].to(dev, torch.bfloat16)
    for m in kernel_mods:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = fm_step(tr.gen_params, lat, emb, draws)
    torch.cuda.synchronize()
    fm = {"loss": float(metrics["loss"]), "grad_norm": train_mod.grad_norm(tr.gen_params),
          "ms": (time.perf_counter() - t0) * 1e3,
          "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    launches_fm, plain_fm = read_counts()
    want_fm = {"window_bwd": nl, "block_causal_bwd": nl}
    phase("train_step_flow_matching", model="t2v-1.3B", tier="bf16", latents=[6, *latent],
          **fm, launches=launches_fm, expected_backward=want_fm, card=card)
    phase("training", model="t2v-1.3B", build_s=build_s, dmd_launches=launches_dmd,
          expected_backward=want_dmd, plain_on_cuda={**plain_dmd, **plain_fm}, params_moved=moved,
          card=card)
    finite = all(math.isfinite(r[k]) and r[k] != 0 for r in steps
                 for k in ("gen_loss", "critic_loss", "gen_grad_norm", "critic_grad_norm"))
    finite = finite and all(math.isfinite(fm[k]) and fm[k] != 0 for k in ("loss", "grad_norm"))
    if not finite:
        fail(f"training: a loss or gradient norm is not finite and nonzero: {steps} {fm}")
    if not all(all(m.values()) for m in moved.values()):
        fail(f"training: params did not move: {moved}")
    if any({k: launches_dmd[k] for k in want_dmd}[k] != v for k, v in want_dmd.items()) or \
            any(launches_fm[k] != v for k, v in want_fm.items()):
        fail(f"training: backward launches {launches_dmd} / {launches_fm}, expected "
             f"{want_dmd} / {want_fm}")
    if any(plain_dmd.values()) or any(plain_fm.values()):
        fail(f"training: a plain version saw a CUDA tensor: {plain_dmd} {plain_fm}")
    out.update(steps=steps, flow_matching=fm, launches_dmd=launches_dmd,
               launches_flow_matching=launches_fm, build_s=build_s)
    del tr, opt, fm_step, lat, emb, watch, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: the GAN phase's adversarial weights: 1, not the default 1e-2, so that the
#: classify branch carries a large share of each gradient held below
GAN_SMOKE_CONFIG = dict(gan_g_weight=1.0, gan_d_weight=1.0, r1_weight=1.0, r2_weight=1.0)


def _classify_counter(read_counts, record):
    """Wrap `wan_dit.dit_classify` so that each call appends the K1 launches
    (and bound pre-passes) it made; returns the restore function."""
    from realtime_video_tpu_torch.models import wan_dit

    real = wan_dit.dit_classify

    def counted(*a, **k):
        before = read_counts()[0]
        out = real(*a, **k)
        after = read_counts()[0]
        record.append({key: after[key] - before[key] for key in ("window", "logit_bound")})
        return out

    wan_dit.dit_classify = counted
    return lambda: setattr(wan_dit, "dit_classify", real)


def gan_phases(card: str, dev, read_counts, kernel_mods, latent=(60, 104)) -> dict:
    """GAN distillation on the card (`training/gan.py`).

    First the generator loss and the critic loss (with a real latent, R1 and
    R2, relativistic off and on) of 2-layer t2v-1.3B-width networks (taps 0
    and 1, 6 latent frames of 16x16) on the card in bf16 against the CPU's
    f32 on the same weights and head, the card's draws replayed: each
    gradient over every trainable leaf (the critic's: the fake score and the
    head) held at DMD's bars, the CPU's bf16 run beside as the control. Then
    train.py's shape at full width (`train.build`'s three t2v-1.3B networks,
    random heads, a seeded static text embedding, 6 latent frames of 60x104)
    with a GAN head from its seed (taps 13 / 21 / 29) and a seeded real
    latent: two generator and two critic updates (AdamW; the critic's params
    are the fake score's and the head's), each with its ms, peak GiB, losses
    and gradient norms (finite and nonzero, the head's gradient too), and
    the launches the code implies: each classify forward 30 self + 30 cross
    K1 launches (and as many bound pre-passes); each forward with a graph
    (every classify forward, the rollout's chosen steps and block 0's
    refresh, the critic's fake-score forward) as many again when layer
    checkpointing reruns it in the backward; the backward kernel once per
    attention whose output reaches the loss. No plain version may see a CUDA
    tensor."""
    import torch

    from realtime_video_tpu_torch import train as train_mod
    from realtime_video_tpu_torch.config import WAN_CONFIGS, load_server_config
    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
    from realtime_video_tpu_torch.training import gan as gan_mod
    from realtime_video_tpu_torch.training import losses
    from realtime_video_tpu_torch.training.draws import TorchDraws
    from realtime_video_tpu_torch.training.train_step import adamw

    out = {}
    t_phase = time.perf_counter()
    # -- 2-layer full-width losses and gradients, card against CPU --
    two = dataclasses.replace(WAN_CONFIGS["t2v-1.3B"], num_layers=2)
    base = dict(denoising_step_list=[1000, 750, 500, 250], guidance_scale=3.0,
                gan_taps=[0, 1], **GAN_SMOKE_CONFIG)
    sides = {"gpu": (dev, torch.bfloat16), "cpu": ("cpu", torch.float32),
             "cpu_bf16": ("cpu", torch.bfloat16)}
    nets = {side: [] for side in sides}
    for s in range(3):
        p = wan_dit.init_wan_params(two, torch.Generator().manual_seed(s), "cpu",
                                    torch.bfloat16)
        p["head"]["head"]["w"] = (torch.randn(p["head"]["head"]["w"].shape,
                                              generator=torch.Generator().manual_seed(20 + s))
                                  * 0.05).to(torch.bfloat16)
        for side, (device, dtype) in sides.items():
            nets[side].append(WanDiffusion(cfg=two, params=tree_to(p, device, dtype),
                                           fuse_qkv=False))
    head = gan_mod.init_gan_head_params(torch.Generator().manual_seed(gan_mod.GAN_HEAD_SEED),
                                        two, num_registers=2)
    ctx = torch.randn((1, 512, two.text_dim), generator=torch.Generator().manual_seed(3))
    noise = torch.randn((1, 6, 16, 16, 16), generator=torch.Generator().manual_seed(4))
    real = torch.randn((1, 6, 16, 16, 16), generator=torch.Generator().manual_seed(6))
    cases = {"generator": {}, "critic_standard": {"relativistic_discriminator": False},
             "critic_relativistic": {"relativistic_discriminator": True}}
    grads = {case: {} for case in cases}
    loss_of = {case: {} for case in cases}
    for case, extra in cases.items():
        record = None
        for side, (device, dtype) in sides.items():
            g, r, f = nets[side]
            with torch.no_grad():
                cross = g.compute_crossattn_cache(ctx.to(device, dtype))
                cross_u = g.compute_crossattn_cache(-ctx.to(device, dtype))
            model = gan_mod.GAN(g, r, f, load_server_config(**base, **extra),
                                gan_params=tree_to(head, device))
            draws = (RecordingDraws(TorchDraws(5, dev)) if side == "gpu"
                     else ReplayDraws(record))
            if case == "generator":
                params = losses.trainable(g.params)
                loss, _ = model.generator_loss(params, f.params, noise.to(device, dtype),
                                               cross, cross_u, draws)
            else:
                params = (losses.trainable(f.params), losses.trainable(model.gan_params))
                loss, _ = model.critic_loss(params, g.params, noise.to(device, dtype), cross,
                                            draws, real_latent=real.to(device, dtype))
            loss.backward()
            if side == "gpu":
                record = draws.items
            loss_of[case][side] = float(loss.detach())
            leaves = losses.tree_leaves(params)
            grads[case][side] = torch.cat([t.grad.double().cpu().flatten()
                                           for t in leaves.values() if t.grad is not None])
            if case != "generator" and side == "gpu":
                head_grad = sum(float(t.grad.abs().sum()) for k, t in leaves.items()
                                if k.startswith("1/") and t.grad is not None)
                if not head_grad > 0:
                    fail(f"gan {case}: the GAN head got no gradient on the card")
            for t in leaves.values():
                t.grad = None
                t.requires_grad_(False)

    def against_f32(case, side):
        got, want = grads[case][side], grads[case]["cpu"]
        return (cosine(got, want), float(got.norm() / want.norm()),
                float((got - want).norm() / want.norm()))

    out["grad_card_vs_cpu"] = {}
    for case in cases:
        cos, ratio, rel_fro = against_f32(case, "gpu")
        c_cos, c_ratio, c_rel_fro = against_f32(case, "cpu_bf16")
        rel_loss = abs(loss_of[case]["gpu"] - loss_of[case]["cpu"]) / abs(loss_of[case]["cpu"])
        out["grad_card_vs_cpu"][case] = dict(
            loss_card=loss_of[case]["gpu"], loss_cpu=loss_of[case]["cpu"],
            loss_rel_err=rel_loss, grad_cosine=cos, grad_norm_ratio=ratio, grad_rel_fro=rel_fro,
            grad_norm_card=float(grads[case]["gpu"].norm()),
            grad_norm_cpu=float(grads[case]["cpu"].norm()),
            control_cpu_bf16=dict(loss=loss_of[case]["cpu_bf16"], grad_cosine=c_cos,
                                  grad_norm_ratio=c_ratio, grad_rel_fro=c_rel_fro))
    phase("gan_grad_2layer_card_vs_cpu", layers=2, dim=two.dim, heads=two.num_heads,
          latents=[6, 16, 16], taps=[0, 1], weights=GAN_SMOKE_CONFIG, real_latent=True,
          **out["grad_card_vs_cpu"],
          bars=dict(grad_cosine=GRAD_COSINE_BAR, norm_ratio=GRAD_NORM_RATIO_BAR,
                    rel_fro=GRAD_REL_FRO_BAR, loss_rel_err=5e-2),
          phase_s=time.perf_counter() - t_phase, card=card)
    for case, res in out["grad_card_vs_cpu"].items():
        if not (res["grad_cosine"] > GRAD_COSINE_BAR
                and abs(res["grad_norm_ratio"] - 1) < GRAD_NORM_RATIO_BAR
                and res["grad_rel_fro"] < GRAD_REL_FRO_BAR and res["loss_rel_err"] < 5e-2
                and torch.isfinite(grads[case]["gpu"]).all()):
            fail(f"gan {case}: the gradient on the card disagrees with the CPU's: {res}")
    del nets, grads
    gc.collect()
    torch.cuda.empty_cache()

    # -- train.py's shape at t2v-1.3B full width, with the GAN head --
    t_phase = time.perf_counter()
    args = train_mod.parse_args([
        "--config", train_mod.TRAIN_CONFIG, "--text-encoder", "seeded",
        "--lr", "1e-4", "--critic-lr", "1e-4", "--latent", str(latent[0]), str(latent[1]),
        "--device", str(dev)])
    tr = train_mod.build(args)
    config = load_server_config(train_mod.TRAIN_CONFIG, **GAN_SMOKE_CONFIG)
    m = tr.model
    model = gan_mod.GAN(m.generator, m.real_score, m.fake_score, config)
    cfg = m.generator.cfg
    nl, nb = cfg.num_layers, args.num_frames // model.num_frame_per_block
    if model.taps != (13, 21, 29):
        fail(f"train_step_gan: taps {model.taps}")
    gan_params = losses.trainable(model.gan_params)
    critic_opt = adamw((tr.fake_params, gan_params), args.critic_lr, 0.01)
    real = torch.randn((1, args.num_frames, cfg.in_dim, *latent),
                       generator=torch.Generator(device=dev).manual_seed(100), device=dev,
                       dtype=torch.float32).to(torch.bfloat16)
    # backward kernels: the rollout's (DMD's 2 x (nb nl + (nb - 1)(nl - 1)):
    # every layer of the chosen steps, block 0's refresh but for its last
    # layer's attention outputs) and 2 nl per classify forward with a graph
    # (1 in a generator update; fake, real and the R1 / R2 perturbed inputs
    # in a critic update) and per fake-score forward (the critic's base loss);
    # K1 launches rerun by checkpointing: 2 nl per forward with a graph
    want = {"generator": {"window_bwd": 2 * (nb * nl + (nb - 1) * (nl - 1)) + 2 * nl,
                          "recompute_window": 2 * nl * (2 * nb - 1) + 2 * nl,
                          "classify_calls": 1},
            "critic": {"window_bwd": 5 * 2 * nl, "recompute_window": 5 * 2 * nl,
                       "classify_calls": 4}}
    steps, plain = [], {}
    for step in range(2):
        draws = TorchDraws(tr.seed * 1_000_003 + step, dev)
        with torch.no_grad():
            embeds = tr.text_encoder([tr.prompts[0]])["prompt_embeds"].to(dev, torch.bfloat16)
            neg = tr.text_encoder([train_mod.SAMPLE_NEG_PROMPT])["prompt_embeds"].to(
                dev, torch.bfloat16)
            cross = m.generator.compute_crossattn_cache(embeds, params=tr.gen_params)
            cross_u = m.generator.compute_crossattn_cache(neg, params=tr.gen_params)
        noise = draws.normal((1, args.num_frames, cfg.in_dim, *latent), torch.bfloat16, dev)
        for update in ("generator", "critic"):
            opt = tr.gen_opt if update == "generator" else critic_opt
            params = tr.gen_params if update == "generator" else (tr.fake_params, gan_params)
            calls = []
            restore = _classify_counter(read_counts, calls)
            for km in kernel_mods:
                km.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                opt.zero_grad(set_to_none=True)
                if update == "generator":
                    loss, aux = model.generator_loss(tr.gen_params, tr.fake_params, noise,
                                                     cross, cross_u, draws)
                else:
                    loss, aux = model.critic_loss(params, tr.gen_params, noise, cross, draws,
                                                  real_latent=real)
                fwd_counts = read_counts()[0]
                loss.backward()
                norm = train_mod.grad_norm(params)
                opt.step()
                torch.cuda.synchronize()
            finally:
                restore()
            ms = (time.perf_counter() - t0) * 1e3
            launches, plain_u = read_counts()
            plain = {k: plain.get(k, 0) + v for k, v in plain_u.items()}
            rec = dict(step=step, update=update, ms=ms,
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                       loss=float(loss.detach()),
                       **{k: float(v.detach()) for k, v in aux.items()}, grad_norm=norm,
                       launches=launches, classify_launches=calls,
                       recompute_window=launches["window"] - fwd_counts["window"])
            if update == "critic":
                rec["head_grad_norm"] = train_mod.grad_norm(gan_params)
            got = {"window_bwd": launches["window_bwd"],
                   "recompute_window": rec["recompute_window"], "classify_calls": len(calls)}
            phase("train_step_gan", model="t2v-1.3B", tier="bf16", latents=[6, *latent],
                  taps=list(model.taps), weights=GAN_SMOKE_CONFIG, **rec,
                  expected=want[update], card=card)
            steps.append(rec)
            finite = all(math.isfinite(rec[k]) and rec[k] != 0
                         for k in ("loss", "grad_norm", "gan_g_loss" if update == "generator"
                                   else "gan_d_loss"))
            if not finite or (update == "critic" and not rec["head_grad_norm"] > 0):
                fail(f"train_step_gan: a loss or gradient norm is not finite and nonzero: {rec}")
            if got != want[update] or launches["block_causal_bwd"] or any(
                    c != {"window": 2 * nl, "logit_bound": 2 * nl} for c in calls):
                fail(f"train_step_gan {update}: launches {got}, classify {calls}, expected "
                     f"{want[update]} and {2 * nl} K1 launches a classify forward")
    if any(plain.values()):
        fail(f"train_step_gan: a plain version saw a CUDA tensor: {plain}")
    out.update(steps=steps, expected=want, phase_s=time.perf_counter() - t_phase)
    del tr, model, m, critic_opt, gan_params, real, cross, cross_u, noise
    gc.collect()
    torch.cuda.empty_cache()
    out["register_attention"] = register_attention_phase(card, dev)
    return out


def register_attention_phase(card: str, dev, lk: int = 9360, heads: int = 12) -> dict:
    """The GAN register token's attention (Lq = 1 over a layer's 9360
    tokens, 12 heads of 128, bf16): `wan_dit.register_attention`'s torch ops
    against K1's route (`window_attention`, bound pre-pass + kernel; its
    backward kernel under a gradient), forward and forward + backward, CUDA
    events in turns, beside the bound (K and V read once). For the record:
    the route stays torch ops, as no TPU kernel stands behind it."""
    import torch

    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.ops import hopper_attention as hk

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = rnd(1, 1, heads, 128), rnd(1, lk, heads, 128), rnd(1, lk, heads, 128)
    do = rnd(1, 1, heads, 128)
    forms = {"torch_ops": wan_dit.register_attention,
             "k1_route": lambda q_, k_, v_: hk.window_attention(q_, k_, v_, 0, lk)}
    outs, grads = {}, {}
    for name, fn in forms.items():
        outs[name] = fn(q, k, v).float()
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        fn(qg, kg, vg).backward(do)
        grads[name] = [t.grad.float() for t in (qg, kg, vg)]

    def fwd_bwd(fn):
        def run():
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            fn(qg, kg, vg).backward(do)
        return run

    times = {f"{name}_{kind}_ms": [] for name in forms for kind in ("fwd", "fwd_bwd")}
    for name in ("torch_ops", "k1_route", "k1_route", "torch_ops"):
        with torch.no_grad():
            times[f"{name}_fwd_ms"].append(event_ms(lambda: forms[name](q, k, v), 50))
        times[f"{name}_fwd_bwd_ms"].append(event_ms(fwd_bwd(forms[name]), 20))
    times = {key: sum(vals) / len(vals) for key, vals in times.items()}
    bytes_kv = 2 * lk * heads * 128 * 2
    bound_ms, bound_by = bound(bytes_kv + 2 * heads * 128 * 2, 4 * lk * heads * 128, "bf16")
    agree = {"out": hk.agreement(outs["k1_route"], outs["torch_ops"])}
    for i, name in enumerate(("dq", "dk", "dv")):
        want = grads["torch_ops"][i]
        agree[name] = hk.agreement(grads["k1_route"][i], want, atol=hk.grad_atol(want))
    res = dict(lq=1, lk=lk, heads=heads, head_dim=128, **times, bound_ms=bound_ms,
               bound_by=bound_by, kv_bytes=bytes_kv, agreement=agree,
               route="torch ops (no TPU kernel behind it)")
    phase("gan_register_attention", **res, phase_s=time.perf_counter() - t_phase, card=card)
    if not all(a["within_tol"] for a in agree.values()):
        fail(f"gan_register_attention: K1's route and the torch ops disagree: {agree}")
    return res


def ode_pairs_phase(card: str, dev, read_counts, kernel_mods, steps: int = 4) -> dict:
    """The ODE-pair data path at full size: `generate_ode_pairs` (the CLI's
    `main`) on t2v-1.3B in bf16 with a random head, 2 prompts, 21 latents of
    60x104 (832x480; 32760 tokens, each attending to all: K1 unmasked),
    `steps` UniPC steps in place of the default 48 (the cut), each forward
    timed with CUDA events; its K1 launches must be 2 x 30 a forward (with as
    many bound pre-passes) and no plain version may see a CUDA tensor. Then
    `create_shards` repacks the shard, `ODERegressionNpzDataset` must read
    back the arrays and prompts bit for bit, and one `ode_regression_loss`
    update (backward and AdamW) of a t2v-1.3B generator (seed 0, random
    head) regresses the trajectory's end from its step-1 point: its ms, peak
    GiB, finite nonzero loss and gradient norm, and the launches of one
    block-causal train-mode forward (30 block-causal + 30 cross K1/K2
    launches, again in the checkpointed backward, and 30 + 30 backward
    kernels)."""
    import numpy as np
    import torch

    from realtime_video_tpu_torch import train as train_mod
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
    from realtime_video_tpu_torch.scripts import create_shards, generate_ode_pairs
    from realtime_video_tpu_torch.solvers import FlowUniPCMultistep
    from realtime_video_tpu_torch.training import distillation, losses
    from realtime_video_tpu_torch.training.train_step import adamw
    from realtime_video_tpu_torch.utils.dataset import ODERegressionNpzDataset

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="rtv_ode_"))
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    prompts = ["a red fox running through snow", "a cat surfing a wave at sunset"]
    (work / "prompts.txt").write_text("\n".join(prompts) + "\n")
    (work / "teacher.yaml").write_text("model_name: t2v-1.3B\ntimestep_shift: 5.0\n"
                                       "random_heads: true\n")
    events, forward = [], WanDiffusion.forward

    def timed(self, *a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = forward(self, *a, **k)
        e1.record()
        events.append((e0, e1))
        return res

    for m in kernel_mods:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    WanDiffusion.forward = timed
    static = os.environ.get("USE_STATIC_ENCODER_COND_DICT")
    os.environ["USE_STATIC_ENCODER_COND_DICT"] = "1"  # no umT5-xxl build here
    t0 = time.perf_counter()
    try:
        written = generate_ode_pairs.main([
            "--prompts", str(work / "prompts.txt"), "--out", str(work / "dumps"),
            "--steps", str(steps), "--num-frames", "21", "--config", str(work / "teacher.yaml"),
            "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        WanDiffusion.forward = forward
        if static is None:
            os.environ.pop("USE_STATIC_ENCODER_COND_DICT")
        else:
            os.environ["USE_STATIC_ENCODER_COND_DICT"] = static
    wall_s = time.perf_counter() - t0
    launches, plain = read_counts()
    forward_ms = [a.elapsed_time(b) for a, b in events]
    with np.load(written[0]) as shard:
        dumped = {key: shard[key] for key in shard.files}
    trajs = [dumped[f"ode_latent_{i}"] for i in range(len(prompts))]
    shapes = {key: [list(a.shape), str(a.dtype)] for key, a in dumped.items()}
    want_k1 = 2 * 30 * steps * len(prompts)
    res = dict(model="t2v-1.3B", tier="bf16", prompts=len(prompts), steps=steps,
               cut="--steps 4 in place of 48", latents=[21, 60, 104], tokens=21 * 1560,
               wall_s=wall_s, forward_ms=forward_ms,
               forward_ms_mean=float(np.mean(forward_ms)), shard_files=len(written),
               shard=shapes, peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               launches=launches, k1_launches_expected=want_k1, plain_on_cuda=plain,
               trajectory_moves=[float(np.abs(t[-1].astype(np.float32)
                                              - t[0].astype(np.float32)).mean())
                                 for t in trajs])
    ok = (len(written) == 1 and len(forward_ms) == steps * len(prompts)
          and all(t.shape == (steps + 1, 1, 21, 16, 60, 104) and t.dtype == np.float16
                  and np.isfinite(t).all() for t in trajs)
          and all(m_ > 0 for m_ in res["trajectory_moves"]))
    if not ok or launches["window"] != want_k1 or launches["logit_bound"] != want_k1 \
            or any(plain.values()):
        phase("ode_pairs", **res, card=card)
        fail(f"ode_pairs: the teacher's shard or launches are wrong: {res}")

    # repack, read back
    n_shards = create_shards.main(["--src", str(work / "dumps"), "--out", str(work / "shards"),
                                   "--shard-size", "2"])
    ds = ODERegressionNpzDataset(str(work / "shards"))
    readback = n_shards == 1 and len(ds) == len(prompts) and all(
        ds[i]["prompts"] == prompts[i] and ds[i]["ode_latent"].dtype == np.float16
        and np.array_equal(ds[i]["ode_latent"], trajs[i]) for i in range(len(prompts)))
    res["readback_equal"] = readback
    if not readback:
        phase("ode_pairs", **res, card=card)
        fail("ode_pairs: create_shards / ODERegressionNpzDataset do not give the dumps back")

    # one ODE-regression generator update on the trajectory
    gen = WanDiffusion(model_name="t2v-1.3B", device=dev, seed=0, fuse_qkv=False)
    train_mod.random_head(gen, 20)
    params = losses.trainable(gen.params)
    opt = adamw(params, 1e-4, 0.01)
    traj = torch.from_numpy(np.asarray(ds[0]["ode_latent"]))
    solver = FlowUniPCMultistep(shift=5.0)
    solver.set_timesteps(steps)
    t_1 = torch.full((1, 21), float(solver.timesteps[1]), device=dev)
    emb = torch.randn((1, 512, gen.cfg.text_dim), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        cross = gen.compute_crossattn_cache(emb.to(dev, torch.bfloat16))
    noisy, target = (traj[i].to(dev, torch.bfloat16) for i in (1, -1))
    for m in kernel_mods:
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = distillation.ode_regression_loss(gen, params, noisy, target, t_1, cross)
    loss.backward()
    norm = train_mod.grad_norm(params)
    opt.step()
    torch.cuda.synchronize()
    upd = dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(loss.detach()),
               grad_norm=norm, peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    launches_u, plain_u = read_counts()
    want_u = {"block_causal": 60, "window": 60, "block_causal_bwd": 30, "window_bwd": 30}
    res.update(ode_regression_update=upd, update_launches=launches_u,
               update_launches_expected=want_u, phase_s=time.perf_counter() - t_phase)
    phase("ode_pairs", **res, card=card)
    if not all(math.isfinite(upd[k]) and upd[k] != 0 for k in ("loss", "grad_norm")):
        fail(f"ode_pairs: the regression update's loss or gradient is not finite and "
             f"nonzero: {upd}")
    if any(launches_u[k] != v for k, v in want_u.items()) or any(plain_u.values()):
        fail(f"ode_pairs: update launches {launches_u}, expected {want_u}; plain {plain_u}")
    del gen, params, opt, loss, cross, noisy, target
    gc.collect()
    torch.cuda.empty_cache()
    return res


#: the server the warm-up phase starts in a fresh process: `create_app` as
#: the entry point builds it (CONFIG, DEVICE and DO_COMPILE from the
#: environment), its warm-up record on one stdout line, then serving on
#: 127.0.0.1:PORT
WARMUP_SERVER = """
import json, logging, os, sys, time
t0 = time.perf_counter()
logging.basicConfig(level=logging.INFO, stream=sys.stderr)
from aiohttp import web
from realtime_video_tpu_torch.serving import server
app = server.create_app()
print(json.dumps({"create_app_s": time.perf_counter() - t0,
                  "warmup": app.get("warmup")}), flush=True)
web.run_app(app, host="127.0.0.1", port=int(os.environ["PORT"]), print=None)
"""


#: teacher forcing at train.py's shape: 6 latent frames of 60x104 (1560
#: tokens a frame) as [clean | noisy], blocks of 3 frames: L 9360, 2L 18720
TF_HALF, TF_BLOCK = 6 * 1560, 3 * 1560
#: the forward's row slices, each held against all 2L keys: clean block 0,
#: the straddle of L (9360 = 73 * 128 + 16), the noisy block boundary, the
#: last rows
TF_SLICES = (("clean_block0", 0, 1024), ("l_straddle", TF_HALF - 512, TF_HALF + 512),
             ("noisy_block_boundary", TF_HALF + TF_BLOCK - 512, TF_HALF + TF_BLOCK + 512),
             ("last_rows", 2 * TF_HALF - 1024, 2 * TF_HALF))
#: under K1's static max (the default) block 0's noisy flow moves with block
#: 1's clean frames through the logit bound, which spans every query row as
#: JAX's does (pallas_attention.py:437-442): 0.73% relative Frobenius on an
#: H100 at random weights, beside 0.78% for block 1's real dependence on
#: block 0. The limit, twice that reading, catches a gross leak on the
#: default path only: a leak of the real dependence's size stays under it,
#: and the bit-exact check under the running max is the one that catches it
TF_STATIC_MAX_COUPLING_LIMIT = 0.015


def sdpa_backend_name(q, k, v, mask, scale) -> str:
    """The backend torch SDPA's dispatcher picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        choice = int(torch._fused_sdp_choice(q, k, v, mask, 0.0, False, scale=scale))
    except (AttributeError, RuntimeError, TypeError) as e:
        return f"not named ({type(e).__name__})"
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(choice, str(choice))


def teacher_forcing_kernel_phase(card: str, dev, heads: int = 12) -> dict:
    """Mode 2 of csrc/attention_sm90.cu and csrc/attention_bwd_sm90.cu at
    train.py's teacher-forcing shape (2L = 18720, blocks of 4680, 12 heads,
    head dim 128, bf16). The forward (with its LSE) against the plain
    version on TF_SLICES, each slice against every key, with
    `hopper_attention.agreement`: the output of the wrapper the main path
    calls (`teacher_forcing_attention`, without a gradient and under
    autograd through `KernelAttention`) and of the launch with the LSE (LSE
    within 2e-3 of the plain LSE of the prescaled q); the backward on the
    whole call against `kernel_backward_plain` under the mode-2 Mask, one
    head at a time so that its f32 [2L, 2L] temporaries fit, at
    `grad_atol`: `attention_backward` (two launches bit-equal) and the
    gradient autograd takes through the wrapper. Planted faults that must fail: a noisy block that sees its
    own clean block, the noisy range 16 keys short, the clean range dropped
    for blocks j >= 1 (forward); the dK/dV pass skipping a clean key's later
    noisy queries, and the leak (backward). CUDA-event times of the route
    (one launch), the forward with its LSE, the backward, the plain
    versions, and torch SDPA under the dense bool mask forward and backward
    (the backend its dispatcher picks, named), beside the bounds of the
    live pairs (`teacher_forcing_pairs`)."""
    import torch
    import torch.nn.functional as F

    from realtime_video_tpu_torch.ops import hopper_attention as hk

    t_phase = time.perf_counter()
    hd, L, B = 128, TF_HALF, TF_BLOCK
    n = 2 * L
    scale = hd ** -0.5
    mask = hk.Mask.teacher_forcing(L, B)
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn((1, n, heads, hd), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    dense = mask.dense(n, n, dev)  # the plain versions' and SDPA's mask, never the kernel's

    def plain_rows(lo, hi):
        """(out, lse) of rows [lo, hi) against every key: the plain forward,
        and the LSE of the prescaled q the kernel scores."""
        out = hk._masked_softmax_attention(q[:, lo:hi], k, v, dense[lo:hi], scale)
        logits = torch.einsum("bqnd,bknd->bnqk", hk.prescale(q[:, lo:hi], scale).float(),
                              k.float()) / hk.LOG2E
        return out, torch.logsumexp(logits.masked_fill(~dense[lo:hi], hk.NEG_INF), -1)

    # the forward as the main path calls it: the route without a gradient,
    # and KernelAttention (the route under autograd) with its backward; the
    # launch with the LSE for the LSE bar and the planted faults
    routed = hk.teacher_forcing_attention(q, k, v, L, B)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    autograd_out = hk.teacher_forcing_attention(qg, kg, vg, L, B)
    autograd_grads = torch.autograd.grad(autograd_out, (qg, kg, vg), do)
    autograd_out = autograd_out.detach()
    del qg, kg, vg
    out, lse = hk._launch_sm90(q, k, v, scale, None, *mask.kernel_args(), with_lse=True)
    fwd, want_rows, lse_err = {}, {}, {}
    for name, lo, hi in TF_SLICES:
        want, want_lse = plain_rows(lo, hi)
        want_rows[name] = want
        for form, got_rows in (("", routed), ("_autograd", autograd_out), ("_with_lse", out)):
            fwd[name + form] = hk.agreement(got_rows[:, lo:hi], want)
        lse_err[name] = (lse[:, :, lo:hi] - want_lse).abs().max().item()
        del want_lse
    del routed, autograd_out
    fwd_faults = {}
    for fault, code in (("noisy_sees_own_clean_block", hk.FAULT_TF_LEAK),
                        ("noisy_range_16_short", hk.FAULT_TF_SHORT),
                        ("clean_dropped_for_j_ge_1", hk.FAULT_TF_DROP_CLEAN)):
        bad = hk._launch_sm90(q, k, v, scale, None, *mask.kernel_args(), fault=code)
        fwd_faults[fault] = any(not hk.agreement(bad[:, lo:hi], want_rows[name])["within_tol"]
                                for name, lo, hi in TF_SLICES)
        del bad
    del want_rows

    got = hk.attention_backward(q, k, v, out, do, lse, scale, mask)
    again = hk.attention_backward(q, k, v, out, do, lse, scale, mask)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    t0 = time.perf_counter()
    parts = [hk.kernel_backward_plain(q[:, :, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1],
                                      out[:, :, h:h + 1], do[:, :, h:h + 1], scale, mask)
             for h in range(heads)]
    torch.cuda.synchronize()
    plain_bwd_ms = (time.perf_counter() - t0) * 1e3
    want = [torch.cat([p[i] for p in parts], 2) for i in range(3)]
    del parts
    bwd = {g: hk.agreement(a, b, hk.grad_atol(b)) for g, a, b in zip(("dq", "dk", "dv"), got, want)}
    bwd.update({f"{g}_autograd": hk.agreement(a, b, hk.grad_atol(b))
                for g, a, b in zip(("dq", "dk", "dv"), autograd_grads, want)})
    del autograd_grads
    bwd_faults = {}
    for fault, code in (("dkdv_skips_later_noisy_queries", hk.FAULT_TF_SKIP_NOISY_Q),
                        ("noisy_sees_own_clean_block", hk.FAULT_TF_LEAK)):
        bad = hk.attention_backward(q, k, v, out, do, lse, scale, mask, fault=code)
        bwd_faults[fault] = any(not hk.agreement(a, b, hk.grad_atol(b))["within_tol"]
                                for a, b in zip(bad, want))
        del bad
    del got, want

    # times: the route (one launch, no LSE), the forward with its LSE, the
    # backward (pre-pass, dQ and dK/dV passes), the plain versions one head
    # at a time, torch SDPA under the dense mask
    ms = event_ms(lambda: hk.teacher_forcing_attention(q, k, v, L, B), 20)
    fwd_lse_ms = event_ms(lambda: hk._launch_sm90(q, k, v, scale, None, *mask.kernel_args(),
                                                  with_lse=True), 20)
    bwd_ms = event_ms(lambda: hk.attention_backward(q, k, v, out, do, lse, scale, mask), 10)
    plain_ms = event_ms(lambda: [hk.teacher_forcing_attention_plain(
        q[:, :, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1], L, B) for h in range(heads)], 1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = sdpa_backend_name(qt, kt, vt, dense, scale)
    library_ms = event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=dense,
                                                                 scale=scale), 5)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=dense, scale=scale)
    g = do.transpose(1, 2)
    library_bwd_ms = event_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), g,
                                                          retain_graph=True), 5)
    del qt, kt, vt, qg, kg, vg, o, g
    pairs = hk.teacher_forcing_pairs(L, B)
    if pairs != int(dense.sum()):
        fail(f"teacher forcing: {pairs} live pairs counted, the mask has {int(dense.sum())}")
    fwd_flop = 4.0 * heads * hd * pairs
    row_bytes = 2.0 * n * heads * hd
    bound_ms, bound_by = bound(4 * row_bytes, fwd_flop, "bf16")  # q, k, v in, o out
    bwd_bound_ms, bwd_bound_by = bound(7 * row_bytes + 4.0 * heads * n, 2.5 * fwd_flop, "bf16")
    res = dict(
        half_len=L, block_tokens=B, heads=heads, head_dim=hd, live_pairs_per_head=pairs,
        dense_pairs_per_head=n * n, ms=ms, forward_with_lse_ms=fwd_lse_ms, plain_ms=plain_ms,
        library_ms=library_ms, library=f"torch SDPA {library}, dense bool mask",
        bound_ms=bound_ms, bound_by=bound_by, tflops=fwd_flop / ms / 1e9,
        bwd_ms=bwd_ms, bwd_plain_ms=plain_bwd_ms, bwd_library_ms=library_bwd_ms,
        bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by,
        bwd_tflops=2.5 * fwd_flop / bwd_ms / 1e9,
        max_abs_err=max(r["max_abs_err"] for r in fwd.values()),
        rel_fro_err=max(r["rel_fro_err"] for r in fwd.values()),
        lse_max_abs_err=max(lse_err.values()), lse_slices=lse_err,
        bwd_max_abs_err=max(r["max_abs_err"] for r in bwd.values()),
        bwd_rel_fro_err=max(r["rel_fro_err"] for r in bwd.values()),
        forward_slices={name: {key: r[key] for key in ("max_abs_err", "rel_fro_err",
                                                       "within_tol")}
                        for name, r in fwd.items()},
        backward={gname: {key: r[key] for key in ("max_abs_err", "rel_fro_err", "atol",
                                                  "within_tol")}
                  for gname, r in bwd.items()},
        deterministic=deterministic, forward_faults_caught=fwd_faults,
        backward_faults_caught=bwd_faults, phase_s=time.perf_counter() - t_phase)
    phase("teacher_forcing_kernel", **res, card=card)
    if not all(r["within_tol"] for r in list(fwd.values()) + list(bwd.values())):
        fail(f"teacher forcing: the kernels disagree with their plain versions: {fwd} {bwd}")
    if res["lse_max_abs_err"] > 2e-3:
        fail(f"teacher forcing: the forward's LSE is {res['lse_max_abs_err']} off the plain one")
    if not (all(fwd_faults.values()) and all(bwd_faults.values())):
        fail(f"teacher forcing: a planted fault passes the check: {fwd_faults} {bwd_faults}")
    if not deterministic:
        fail("teacher forcing: two backward launches on the same inputs differ")
    del q, k, v, do, out, lse, dense
    torch.cuda.empty_cache()
    return res


def teacher_forcing_dit_phase(card: str, dev, read_counts, kernel_mods,
                              latent=(60, 104)) -> dict:
    """`dit_forward(tf_concat=True)` at t2v-1.3B full width (30 layers, dim
    1536, random bf16 weights from seed 0, a random head) over [clean |
    noisy] of 6 latent frames of 60x104 each (2L = 18720 tokens, blocks of 3
    frames), t 0 for the clean half and 700 for the noisy, a seeded text
    embedding. The forward (no grad) and the forward + backward of a
    mean-square loss with every param trainable (each layer under
    checkpointing, so each layer's forward runs again in the backward), each
    in ms with syncs after a warm call of each, the peak GiB, and the
    launches against the derivation: a forward launches `teacher_forcing` and
    the cross-attention's K1 once a layer (with its bound pre-pass); the
    forward + backward twice, and `teacher_forcing_bwd` and `window_bwd` once
    a layer. Then JAX's causality test at full width: block 0's noisy flow is
    bit-identical when block 1's clean frames change, and block 1's flow
    moves when block 0's clean frames do. The bit-identity holds under K1's
    running max (STATIC_MAX off): K1's static max takes one logit bound over
    every query row (`logit_bound_maxima`), the clean rows' included, so
    under it block 0's roundings move with the clean frames; that difference
    (`block0_rel_change_static_max`) must stay under
    TF_STATIC_MAX_COUPLING_LIMIT."""
    import torch

    from realtime_video_tpu_torch.config import WAN_CONFIGS
    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
    from realtime_video_tpu_torch.ops import hopper_attention as hk
    from realtime_video_tpu_torch.train import random_head
    from realtime_video_tpu_torch.training import losses

    t_phase = time.perf_counter()
    cfg = WAN_CONFIGS["t2v-1.3B"]
    nl, frames, nfpb = cfg.num_layers, 6, 3
    net = WanDiffusion(cfg=cfg, device=dev, dtype=torch.bfloat16, seed=0)
    random_head(net, 20)
    fsl = (latent[0] // 2) * (latent[1] // 2)
    block = fsl * nfpb
    gen = torch.Generator(device=dev).manual_seed(14)

    def lat():
        return torch.randn((1, frames, cfg.in_dim, *latent), generator=gen,
                           device=dev).to(torch.bfloat16)

    clean, noisy = lat(), lat()
    t = torch.cat([torch.zeros((1, frames)), torch.full((1, frames), 700.0)], 1).to(dev)
    emb = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                      device=dev).to(torch.bfloat16)

    def forward(clean_frames, cross):
        flow, _ = wan_dit.dit_forward(cfg, net.params, torch.cat([clean_frames, noisy], 1), t,
                                      net.rope, cross, mode="train", tf_concat=True,
                                      block_tokens=block)
        return flow

    def reset():
        for m in kernel_mods:
            m.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return time.perf_counter()

    def rel_change(a, b):
        return ((a.float() - b.float()).norm() / a.float().norm()).item()

    out = {}
    clean2 = clean.clone()
    clean2[:, nfpb:] = lat()[:, nfpb:]
    clean3 = clean.clone()
    clean3[:, :nfpb] = lat()[:, :nfpb]
    with torch.no_grad():
        cross = net.compute_crossattn_cache(emb)
        forward(clean, cross)  # warm
        t0 = reset()
        flow = forward(clean, cross)
        torch.cuda.synchronize()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3
        out["forward_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        launches_fwd, plain_fwd = read_counts()
        static_change = rel_change(flow[:, :nfpb], forward(clean2, cross)[:, :nfpb])
        # causality at full width, under K1's running max
        hk_static = hk.STATIC_MAX
        hk.STATIC_MAX = False
        try:
            base = forward(clean, cross)
            flow2, flow3 = forward(clean2, cross), forward(clean3, cross)
        finally:
            hk.STATIC_MAX = hk_static
    block0_same = torch.equal(base[:, :nfpb], flow2[:, :nfpb])
    block1_moves = not torch.allclose(base[:, nfpb:].float(), flow3[:, nfpb:].float())
    block1_change = rel_change(base[:, nfpb:], flow3[:, nfpb:])
    finite = bool(torch.isfinite(flow).all())
    shape = list(flow.shape)
    del flow, base, flow2, flow3, clean2, clean3, cross

    params = losses.trainable(net.params)

    def step():
        for leaf in losses.tree_leaves(params).values():
            leaf.grad = None
        flow = forward(clean, net.compute_crossattn_cache(emb))
        loss = flow.float().square().mean()
        loss.backward()
        return loss.detach()

    step()  # warm: the backward's first launches and allocations
    t0 = reset()
    loss = step()
    torch.cuda.synchronize()
    out["forward_backward_ms"] = (time.perf_counter() - t0) * 1e3
    out["forward_backward_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches_fb, plain_fb = read_counts()
    grad_norm = math.sqrt(sum(float(p.grad.float().square().sum())
                              for p in losses.tree_leaves(params).values() if p.grad is not None))
    want_fwd = {"teacher_forcing": nl, "window": nl, "logit_bound": nl, "teacher_forcing_bwd": 0}
    want_fb = {"teacher_forcing": 2 * nl, "window": 2 * nl, "logit_bound": 2 * nl,
               "teacher_forcing_bwd": nl, "window_bwd": nl}
    out.update(model="t2v-1.3B", layers=nl, dim=cfg.dim, latents=[2 * frames, *latent],
               tokens=2 * frames * fsl, block_tokens=block, flow_shape=shape, finite=finite,
               loss=float(loss), grad_norm=grad_norm, launches_forward=launches_fwd,
               expected_forward=want_fwd, launches_forward_backward=launches_fb,
               expected_forward_backward=want_fb,
               plain_on_cuda={**plain_fwd, **plain_fb},
               block0_noisy_flow_bit_identical=block0_same,
               block0_rel_change_static_max=static_change,
               later_blocks_move=block1_moves, later_blocks_rel_change=block1_change,
               phase_s=time.perf_counter() - t_phase)
    phase("teacher_forcing_1p3b", **out, card=card)
    if not (finite and shape == [1, frames, cfg.out_dim, *latent]
            and math.isfinite(grad_norm) and grad_norm > 0):
        fail(f"teacher_forcing_1p3b: flow {shape}, finite {finite}, grad norm {grad_norm}")
    if any(launches_fwd[k] != v for k, v in want_fwd.items()) or \
            any(launches_fb[k] != v for k, v in want_fb.items()):
        fail(f"teacher_forcing_1p3b: launches {launches_fwd} / {launches_fb}, expected "
             f"{want_fwd} / {want_fb}")
    if any(plain_fwd.values()) or any(plain_fb.values()):
        fail(f"teacher_forcing_1p3b: a plain version saw a CUDA tensor: {plain_fwd} {plain_fb}")
    if not (block0_same and block1_moves):
        fail(f"teacher_forcing_1p3b: causality: block 0 unchanged {block0_same}, later blocks "
             f"move {block1_moves}")
    if not static_change <= TF_STATIC_MAX_COUPLING_LIMIT:
        fail(f"teacher_forcing_1p3b: under the static max block 0's flow moves {static_change} "
             f"with block 1's clean frames, above {TF_STATIC_MAX_COUPLING_LIMIT}")
    del net, params, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def t5_reference_state_dict(params, cfg) -> dict:
    """The port's umT5 tree as a reference-layout state dict on the CPU
    (wan/modules/t5.py's names): the inverse of utils/checkpoint.convert_t5_encoder."""
    sd = {}

    def put(name, t):
        sd[name] = t.detach().cpu().contiguous()

    put("token_embedding.weight", params["token_embedding"])
    put("norm.weight", params["norm"]["scale"])
    bp = params["blocks"]
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        put(f"{b}.norm1.weight", bp["norm1"]["scale"][i])
        for n in ("q", "k", "v", "o"):
            put(f"{b}.attn.{n}.weight", bp["attn"][n]["w"][i].t())
        put(f"{b}.norm2.weight", bp["norm2"]["scale"][i])
        for ref, key in (("gate.0", "gate"), ("fc1", "fc1"), ("fc2", "fc2")):
            put(f"{b}.ffn.{ref}.weight", bp["ffn"][key]["w"][i].t())
        put(f"{b}.pos_embedding.embedding.weight", bp["rel_emb"][i])
    return sd


def vae_reference_state_dict(params, cfg) -> dict:
    """The port's Wan 2.1 VAE tree as a reference-layout state dict on the
    CPU (wan/modules/vae.py's names): the inverse of utils/checkpoint.convert_vae."""
    from realtime_video_tpu_torch.models.vae import _decoder_plan, _encoder_plan

    sd = {}

    def put(name, t):
        sd[name] = t.detach().cpu().contiguous()

    def conv(name, p, perm):
        put(f"{name}.weight", p["w"].permute(*perm))
        put(f"{name}.bias", p["b"])

    def conv3(name, p):  # [kt, kh, kw, in, out] -> [out, in, kt, kh, kw]
        conv(name, p, (4, 3, 0, 1, 2))

    def gamma(name, p):
        put(name, p["gamma"].reshape(-1, 1, 1))

    def res(base, p):
        gamma(f"{base}.residual.0.gamma", p["norm1"])
        conv3(f"{base}.residual.2", p["conv1"])
        gamma(f"{base}.residual.3.gamma", p["norm2"])
        conv3(f"{base}.residual.6", p["conv2"])
        if "shortcut" in p:
            conv3(f"{base}.shortcut", p["shortcut"])

    def attn(base, p):
        gamma(f"{base}.norm.gamma", p["norm"])
        for n in ("to_qkv", "proj"):  # dense [in, out] -> 1x1 Conv2d [out, in, 1, 1]
            put(f"{base}.{n}.weight", p[n]["w"].t()[:, :, None, None])
            put(f"{base}.{n}.bias", p[n]["b"])

    def stage(prefix, plan, ps):
        for i, (spec, p) in enumerate(zip(plan, ps)):
            if spec[0] == "res":
                res(f"{prefix}.{i}", p)
                continue
            if "conv" in p:  # [kh, kw, in, out] -> [out, in, kh, kw]
                conv(f"{prefix}.{i}.resample.1", p["conv"], (3, 2, 0, 1))
            if "time_conv" in p:
                conv3(f"{prefix}.{i}.time_conv", p["time_conv"])

    enc, dec = params["encoder"], params["decoder"]
    conv3("encoder.conv1", enc["conv1"])
    stage("encoder.downsamples", _encoder_plan(cfg)[1], enc["downsamples"])
    res("encoder.middle.0", enc["middle_res1"])
    attn("encoder.middle.1", enc["middle_attn"])
    res("encoder.middle.2", enc["middle_res2"])
    gamma("encoder.head.0.gamma", enc["head_norm"])
    conv3("encoder.head.2", enc["head_conv"])
    conv3("decoder.conv1", dec["conv1"])
    res("decoder.middle.0", dec["middle_res1"])
    attn("decoder.middle.1", dec["middle_attn"])
    res("decoder.middle.2", dec["middle_res2"])
    stage("decoder.upsamples", _decoder_plan(cfg)[1], dec["upsamples"])
    gamma("decoder.head.0.gamma", dec["head_norm"])
    conv3("decoder.head.2", dec["head_conv"])
    conv3("conv1", params["conv1"])
    conv3("conv2", params["conv2"])
    return sd


def same_state_dict(got: dict, want: dict) -> dict:
    """Whether two state dicts hold the same names, dtypes, shapes and bits."""
    import torch

    names = set(got) == set(want)
    differing = [k for k in want if k in got and not (
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and torch.equal(got[k], want[k]))]
    return {"tensors": len(want), "names_equal": names, "differing": differing[:5],
            "bit_exact": names and not differing}


def real_checkpoint_phase(card: str, dev) -> dict:
    """The real-checkpoint path at full size, in a temporary MODEL_FOLDER
    removed at exit. `scripts/synthesize_checkpoint --t5 full` writes the
    1.3B DiT (safetensors), the Wan 2.1 VAE (.pth) and umT5-xxl (safetensors)
    in the reference's layout, timed (a subprocess), and the sweep's two
    DiTs, written here: the synthesiser's DiT drawn from seeds 0 and 1, each
    with a random head (the reference's zero head makes every flow zero, so
    that any two checkpoints would sample one video, and the run of
    `run_real_checkpoint` on the zero-head DiT shows the umT5 / VAE side and
    the script's plumbing but not the DiT's load: the sweep shows that). Each file is loaded and converted on the card and
    inverted back: the state dict must come back bit for bit (the DiT
    through `reference_state_dict`, umT5 and the VAE through their inverses
    here). Then `scripts/run_real_checkpoint` in a subprocess (MODEL_FOLDER
    set, the fallback tokenizer, the bf16 tier, 832x480, 3 blocks, 4 steps):
    30 finite frames, its checksum, each file's load-and-convert seconds
    and the load's peak. Then `sweep_sample` over the two sweep DiTs (1
    prompt, 1 block, the static text embedding): the two outputs must
    differ, and the first must equal a direct `sample_videos` of a server
    loaded from the same file."""
    import numpy as np
    import torch

    from safetensors.torch import save_file

    from realtime_video_tpu_torch import sweep_sample
    from realtime_video_tpu_torch.config import (T5_CONFIGS, VAE_CONFIGS, WAN_CONFIGS,
                                                 load_server_config)
    from realtime_video_tpu_torch.sample import sample_videos
    from realtime_video_tpu_torch.scripts import synthesize_checkpoint as synth
    from realtime_video_tpu_torch.serving.models import load_all
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    repo = Path(__file__).resolve().parent
    folder = tempfile.mkdtemp(prefix="rtv_models_")
    atexit.register(shutil.rmtree, folder, ignore_errors=True)
    free_gib = shutil.disk_usage(folder).free / 2 ** 30
    if free_gib < 30:
        fail(f"real_checkpoint: {free_gib:.1f} GiB free under {folder}, 30 needed")
    env = {k: v for k, v in os.environ.items() if k != "USE_STATIC_ENCODER_COND_DICT"}
    env.update(MODEL_FOLDER=folder, RTV_QUANT_CACHE="0",
               PYTHONPATH=os.pathsep.join([str(repo), env.get("PYTHONPATH", "")]))

    def run(args, timeout):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=repo, env=env,
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode:
            fail(f"real_checkpoint: {args[0]} exited {proc.returncode}: "
                 f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
        return proc.stdout, time.perf_counter() - t0

    sweep_dir = os.path.join(folder, "sweep")
    _, synth_s = run(["realtime_video_tpu_torch.scripts.synthesize_checkpoint", "--out", folder,
                      "--t5", "full"], 600)
    t0 = time.perf_counter()
    os.makedirs(sweep_dir)
    ckpts = []
    for seed in (0, 1):  # the synthesiser's DiT from `seed`, its head N(0, 0.05) from 20 + seed
        synth.GEN.manual_seed(seed)
        sd = synth.synth_dit(WAN_CONFIGS["t2v-1.3B"])
        w = sd["head.head.weight"]
        head_gen = torch.Generator().manual_seed(20 + seed)
        sd["head.head.weight"] = (torch.randn(w.shape, generator=head_gen) * 0.05).to(w.dtype)
        ckpts.append(os.path.join(sweep_dir, f"dit_seed{seed}.safetensors"))
        save_file(sd, ckpts[-1])
        del sd, w
    sweep_synth_s = time.perf_counter() - t0
    base = os.path.join(folder, "Wan2.1-T2V-1.3B")
    files = {"dit": os.path.join(folder, synth.DIT_NAME),
             "vae": os.path.join(base, "Wan2.1_VAE.pth"),
             "umt5": os.path.join(base, "models_t5_umt5-xxl-enc-bf16.safetensors")}
    file_gib = {k: os.path.getsize(p) / 2 ** 30 for k, p in files.items()}

    # full-size round trips: load, convert on the card, invert, compare bits
    round_trip = {}
    for name, path in files.items():
        t0 = time.perf_counter()
        sd = ckpt.load_torch_state_dict(path)
        t1 = time.perf_counter()
        if name == "dit":
            cfg = ckpt.detect_wan_config(sd)
            tree = ckpt.convert_wan_dit(sd, cfg, device=dev)
            back = reference_state_dict(tree, cfg)
        elif name == "umt5":
            cfg = T5_CONFIGS["umt5-xxl"]
            tree = ckpt.convert_t5_encoder(sd, cfg, device=dev)
            back = t5_reference_state_dict(tree, cfg)
        else:
            cfg = VAE_CONFIGS["wan2.1"]
            tree = ckpt.convert_vae(sd, cfg, device=dev)
            back = vae_reference_state_dict(tree, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        round_trip[name] = {**same_state_dict(back, sd), "read_s": t1 - t0,
                            "convert_and_invert_s": t2 - t1}
        del sd, tree, back
        gc.collect()
        torch.cuda.empty_cache()

    out_path = os.path.join(folder, "out", "real_checkpoint.mp4")
    stdout, run_s = run(["realtime_video_tpu_torch.scripts.run_real_checkpoint", "--blocks", "3",
                         "--steps", "4", "--width", "832", "--height", "480", "--out", out_path],
                        900)
    lines = [ln for ln in stdout.splitlines() if ln.startswith('{"real_checkpoint"')]
    if not lines:
        fail(f"real_checkpoint: run_real_checkpoint printed no result: {stdout[-3000:]}")
    rec = json.loads(lines[-1])["real_checkpoint"]

    # the sweep over two checkpoints, and a direct sampler on the first
    yaml_1p3b = str(repo / "realtime_video_tpu_torch" / "configs" / "self_forcing_server.yaml")
    prev = os.environ.get("USE_STATIC_ENCODER_COND_DICT")
    os.environ["USE_STATIC_ENCODER_COND_DICT"] = "1"
    try:
        t0 = time.perf_counter()
        swept = sweep_sample.main([*ckpts, "--config", yaml_1p3b, "--out",
                                   os.path.join(folder, "sweep_out"), "--first-n", "1",
                                   "--num-blocks", "1", "--steps", "4", "--device", str(dev)])
        sweep_s = time.perf_counter() - t0
        first, second = (swept[os.path.splitext(os.path.basename(p))[0]][0] for p in ckpts)
        config = load_server_config(yaml_1p3b, checkpoint_path=ckpts[0])
        models = load_all(config, dev, seed=config.get("seed", 0))
        direct = sample_videos([sweep_sample.SWEEP_PROMPTS[0]], yaml_1p3b,
                               os.path.join(folder, "direct_out"),
                               GenerateParams(prompt="", seed=42, num_blocks=1,
                                              num_denoising_steps=4),
                               models, save_videos=False)[0]
    finally:
        if prev is None:
            os.environ.pop("USE_STATIC_ENCODER_COND_DICT", None)
        else:
            os.environ["USE_STATIC_ENCODER_COND_DICT"] = prev
    sweep = {"frames": list(first.shape), "checkpoints_differ": not np.array_equal(first, second),
             "first_equals_direct_sample": bool(np.array_equal(first, direct)),
             "seconds": sweep_s}
    del models, swept, first, second, direct
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(model="t2v-1.3B", tier="bf16", t5="umt5-xxl (full)", file_gib=file_gib,
               synthesis_s=synth_s, synthesis_sweep_dits_s=sweep_synth_s,
               round_trip=round_trip, run_real_checkpoint=rec, run_s=run_s, sweep=sweep,
               free_gib_before=free_gib, phase_s=time.perf_counter() - t_phase)
    phase("real_checkpoint", **res, card=card)
    if not all(r["bit_exact"] for r in round_trip.values()):
        fail(f"real_checkpoint: a full-size converter round trip is not bit-exact: {round_trip}")
    if rec["frames"] != [30, 3, 480, 832] or not rec["finite"] or \
            set(rec["load_convert_s"]) != {os.path.basename(p) for p in files.values()}:
        fail(f"real_checkpoint: run_real_checkpoint gave {rec}")
    if not (sweep["checkpoints_differ"] and sweep["first_equals_direct_sample"]):
        fail(f"real_checkpoint: sweep {sweep}")
    return res


def _json_or_none(line: str):
    try:
        return json.loads(line)
    except ValueError:
        return None


def server_warmup_phase(card: str, request: dict) -> dict:
    """Two fresh server processes on the 1.3B int8 tier (static text
    embedding, the kernel libraries already built in _build/), one without
    DO_COMPILE and one with DO_COMPILE=1: the warm-up's record (library
    builds and loads; seconds per shape of COMPILE_SHAPES), `create_app`'s
    seconds, and the first session's TTFF and block times at the client
    (2 blocks of `request`). The warm-up must run under DO_COMPILE and not
    without it, and each session must send its 18 frames."""
    import aiohttp
    from msgpack import packb

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="rtv_warmup_"))
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    config = work / "server.yaml"
    config.write_text("model_name: t2v-1.3B\nenable_int8: true\nenable_int8_dit: true\n"
                      "int8_static_scales: true\n")
    req = dict(request, num_blocks=2)

    async def first_session(base):
        async with aiohttp.ClientSession() as client:
            async with client.ws_connect(f"{base.replace('http', 'ws')}/session/warm",
                                         max_msg_size=0) as ws:
                ready = await ws.receive_json(timeout=60)
                if ready.get("status") != "ready":
                    fail(f"server_warmup: no ready message: {ready}")
                stamps = []
                t_send = time.perf_counter()
                await ws.send_bytes(packb(req))
                while True:
                    msg = await ws.receive(timeout=600)
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        stamps.append(time.perf_counter())
                    elif msg.type == aiohttp.WSMsgType.TEXT:
                        final = msg.json()
                        break
                    else:
                        fail(f"server_warmup: socket closed before completion ({msg.type})")
        if final.get("status") != "completed" or len(stamps) != 18:
            fail(f"server_warmup: {len(stamps)} frames, final {final}")
        return dict(ttff_ms=(stamps[0] - t_send) * 1e3,
                    block_ms=[(stamps[5] - t_send) * 1e3, (stamps[17] - stamps[5]) * 1e3])

    async def wait_healthy(base, proc, deadline):
        async with aiohttp.ClientSession() as client:
            while time.perf_counter() < deadline:
                if proc.poll() is not None:
                    return False
                try:
                    async with client.get(f"{base}/health") as r:
                        if r.status == 200:
                            return True
                except aiohttp.ClientError:
                    pass
                await asyncio.sleep(0.5)
        return False

    out = {}
    for label, do_compile in (("cold", None), ("do_compile", "1")):
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            port = s_.getsockname()[1]
        env = dict(os.environ, CONFIG=str(config), PORT=str(port), DEVICE="cuda",
                   USE_STATIC_ENCODER_COND_DICT="1", RTV_QUANT_CACHE="0")
        env.pop("DO_COMPILE", None)
        if do_compile:
            env["DO_COMPILE"] = do_compile
        log_path = work / f"{label}.log"
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, "-c", WARMUP_SERVER], env=env,
                                    cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                                    stderr=log, text=True)
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        base = f"http://127.0.0.1:{port}"
        try:
            if not asyncio.run(wait_healthy(base, proc, t0 + 600)):
                fail(f"server_warmup {label}: the server did not come up: "
                     f"{log_path.read_text()[-4000:]}")
            ready_s = time.perf_counter() - t0
            # the record line (a library may print before it)
            record = next(rec for rec in map(_json_or_none, proc.stdout)
                          if isinstance(rec, dict) and "create_app_s" in rec)
            session = asyncio.run(first_session(base))
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        out[label] = dict(do_compile=do_compile, process_ready_s=ready_s, **record,
                          first_session=session)
        phase("server_warmup", process=label, model="t2v-1.3B", tier="int8",
              **out[label], card=card)
        if (record["warmup"] is not None) != bool(do_compile):
            fail(f"server_warmup {label}: the warm-up ran {record['warmup'] is not None}, "
                 f"DO_COMPILE {do_compile}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: tp (ranks sharing the card) against one process: x0's cosine and relative
#: Frobenius error. The row-parallel partial sums round to bf16 once a rank,
#: so tp is not bit-equal to one device; set from the first readings on an
#: H100 80GB HBM3 at 700 W (1.3B bf16 / int8 static 0.999985 / 0.999967 and
#: 5.5e-3 / 8.1e-3; 14B int8 + INT8_QK 0.999980 and 6.4e-3), about 2.5x
#: their error
TP_COSINE_BAR, TP_REL_FRO_BAR = 0.9999, 2e-2

#: dp 2 x tp 2 against the one-process step: (cosine above, relative
#: Frobenius error below) for the averaged gradient, the AdamW update and
#: the EMA shadow's step. AdamW's first step is about lr * sign(grad) a
#: weight and a bf16 weight moves by whole ulps, so a gradient near 0 that
#: flips its sign moves the update far more than the gradient. The update's
#: and the EMA step's bars are set from the readings on an H100 80GB HBM3 at
#: 700 W: 0.99947 and 3.3e-2 for both, against 0.53-0.78 and 0.66-0.97 under
#: the planted fault (the dp mean dropped)
TRAIN_BARS = {"grads": (0.999, 2e-2), "update": (0.999, 5e-2), "ema_step": (0.999, 5e-2)}


def parallel_phases(card: str) -> dict:
    """The multi-GPU phases (realtime_video_tpu_torch/tools/parallel_smoke.py):
    tp and dp x tp with ranks sharing this card over gloo, the ring's K1
    composition in this process, and NCCL where there are two or more cards.
    Every wall time of ranks that share the card is printed as such."""
    import torch

    from realtime_video_tpu_torch.parallel import launch
    from realtime_video_tpu_torch.tools import parallel_smoke as ps

    dev = torch.device("cuda")
    out = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    compute_mode = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    shared = {"compute_mode": compute_mode, "wall_times": "ranks sharing one card: not a speed "
              "figure"}
    if compute_mode and "exclusive" in compute_mode.lower():
        fail(f"compute mode {compute_mode}: a second process gets no context on this card")

    # -- tp_denoise_1p3b: tp 2, bf16 and int8 static, two ranks on this card --
    t0 = time.perf_counter()
    act_scales = ps.calibrate("t2v-1.3B", dev)
    one = {tier: ps.one_process_block(tier, "t2v-1.3B", dev, act_scales)
           for tier in ("bf16", "int8_static")}
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch.run(ps.tp_denoise_rank, 2, {"tiers": ("bf16", "int8_static"),
                                               "model": "t2v-1.3B", "act_scales": act_scales},
                       backend="gloo", device="cuda", timeout_s=400)
    res = {"model": "t2v-1.3B", "tp": 2, "heads_per_rank": ranks[0]["bf16"]["heads_per_rank"],
           "backend": ranks[0]["backend"],
           "gloo_takes_cuda_all_reduce": ranks[0].get("gloo_takes_cuda_all_reduce"),
           "gloo_error": ranks[0].get("gloo_error"), **shared}
    if not all(r.get("gloo_takes_cuda_all_reduce") for r in ranks):
        phase("tp_denoise_1p3b", **res, card=card)
        fail(f"gloo refuses CUDA tensors on this build: {res['gloo_error']}")
    for tier in ("bf16", "int8_static"):
        want = one[tier]["x0"]
        got = ranks[0][tier]["x0"]
        exp = ps.expected_block_launches(30, tier != "bf16")
        row = {"cosine_vs_one_process": ps.cosine(got, want),
               "rel_fro_vs_one_process": ps.rel_fro(got, want),
               "x0_identical_across_ranks": len({r[tier]["x0_sha256"] for r in ranks}) == 1,
               "launches_per_rank": [r[tier]["launches"] for r in ranks],
               "launches_expected_per_rank": exp,
               "launches_one_process": one[tier]["launches"],
               "shared_card_wall_ms_per_rank": [r[tier]["wall_ms"] for r in ranks],
               "one_process_wall_ms": one[tier]["wall_ms"]}
        res[tier] = row
        counts_ok = all(r[tier]["launches"][k] == v for r in ranks for k, v in exp.items()) \
            and all(r[tier]["launches"]["plain_on_cuda"] == 0 for r in ranks)
        row["bars"] = {"cosine": TP_COSINE_BAR, "rel_fro": TP_REL_FRO_BAR}
        if not (row["cosine_vs_one_process"] > TP_COSINE_BAR
                and row["rel_fro_vs_one_process"] < TP_REL_FRO_BAR
                and row["x0_identical_across_ranks"]
                and bool(torch.isfinite(got).all()) and counts_ok):
            phase("tp_denoise_1p3b", **res, card=card)
            fail(f"tp_denoise_1p3b {tier}: {row}")
    res["phase_s"] = time.perf_counter() - t0
    phase("tp_denoise_1p3b", **res, card=card)
    out["tp_denoise_1p3b"] = res
    del one, ranks
    gc.collect()
    torch.cuda.empty_cache()

    # -- tp_forward_14b: int8 with INT8_QK, 2 layers, tp 4, four ranks --
    t0 = time.perf_counter()
    one14 = ps.one_process_14b(2, dev)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch.run(ps.tp_forward_14b_rank, 4, {"layers": 2}, backend="gloo",
                       device="cuda", timeout_s=400)
    got, want = ranks[0]["x0"], one14["x0"]
    res = {"model": "t2v-14B (2 layers)", "tier": "int8 dynamic + INT8_QK", "tp": 4,
           "heads_per_rank": 10, "backend": ranks[0]["backend"],
           "cosine_vs_one_process": ps.cosine(got, want),
           "rel_fro_vs_one_process": ps.rel_fro(got, want),
           "x0_identical_across_ranks": len({r["x0_sha256"] for r in ranks}) == 1,
           "launches_per_rank": [r["launches"] for r in ranks],
           "launches_one_process": one14["launches"],
           "shared_card_wall_ms_per_rank": [r["wall_ms"] for r in ranks],
           "one_process_wall_ms": one14["wall_ms"],
           "kernels_per_rank": [r["kernels"] for r in ranks],
           "kernel_times": "each rank timed alone (the others wait at a barrier)",
           "bars": {"cosine": TP_COSINE_BAR, "rel_fro": TP_REL_FRO_BAR},
           "phase_s": time.perf_counter() - t0, **shared}
    phase("tp_forward_14b", **res, card=card)
    k3_ok = all(r["kernels"][c]["max_err_bf16_ulps"] <= 1.0 for r in ranks for c in ("qkv", "fc2"))
    att_ok = all(r["kernels"]["attention_int8qk"]["within_tol"] for r in ranks)
    if not (res["cosine_vs_one_process"] > TP_COSINE_BAR
            and res["rel_fro_vs_one_process"] < TP_REL_FRO_BAR
            and res["x0_identical_across_ranks"] and k3_ok
            and att_ok and bool(torch.isfinite(got).all())):
        fail(f"tp_forward_14b: {res}")
    out["tp_forward_14b"] = res
    del ranks, one14
    gc.collect()
    torch.cuda.empty_cache()

    # -- dp_tp_train_step: dp 2 x tp 2, t2v-1.3B width, 2 layers --
    t0 = time.perf_counter()
    ref_dir = tempfile.mkdtemp(prefix="rtv_dp_tp_")
    atexit.register(shutil.rmtree, ref_dir, ignore_errors=True)
    ref_path = os.path.join(ref_dir, "one_process_step.pt")
    one_step = ps.one_process_train(dev, ref_path)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch.run(ps.dp_tp_train_rank, 4, {"reference": ref_path}, backend="gloo",
                       device="cuda", timeout_s=400)
    by = {(r["dp_rank"], r["tp_rank"]): r for r in ranks}
    repl_equal = all(by[(d, 0)]["replicated_sha256"] == by[(d, 1)]["replicated_sha256"]
                     for d in (0, 1))
    exp_bwd = {"block_causal_bwd": ps.TRAIN_LAYERS, "window_bwd": ps.TRAIN_LAYERS}
    res = {"model": "t2v-1.3B width, 2 layers", "dp": 2, "tp": 2,
           "latents": [ps.TRAIN_BATCH, ps.TRAIN_FRAMES, 16, ps.LAT_H, ps.LAT_W],
           "backend": ranks[0]["backend"],
           **{f"{pre}{part}_{m}_per_rank": [r[f"{pre}{part}_{m}"] for r in ranks]
              for pre in ("", "fault_no_dp_mean_") for part in TRAIN_BARS
              for m in ("cosine", "rel_err")},
           "bars": {part: {"cosine_above": c, "rel_err_below": e}
                    for part, (c, e) in TRAIN_BARS.items()},
           "replicated_leaves_bit_equal_over_tp": repl_equal,
           "loss_per_rank": [r["loss"] for r in ranks], "loss_one_process": one_step["loss"],
           "backward_launches_per_rank": [{k: r["launches"][k] for k in exp_bwd}
                                          for r in ranks],
           "backward_launches_expected_per_rank": exp_bwd,
           "launches_one_process": one_step["launches"],
           "shared_card_wall_ms_per_rank": [r["wall_ms"] for r in ranks],
           "one_process_wall_ms": one_step["wall_ms"],
           "peak_gib_per_rank": [r["peak_gib"] for r in ranks],
           "phase_s": time.perf_counter() - t0, **shared}

    def within(r, part, pre=""):
        c, e = TRAIN_BARS[part]
        return r[f"{pre}{part}_cosine"] > c and r[f"{pre}{part}_rel_err"] < e

    # each part's bars on their own must catch the planted fault on every rank
    res["fault_no_dp_mean_caught"] = {
        part: not any(within(r, part, "fault_no_dp_mean_") for r in ranks)
        for part in TRAIN_BARS}
    phase("dp_tp_train_step", **res, card=card)
    if not (all(within(r, part) for r in ranks for part in TRAIN_BARS)
            and all(res["fault_no_dp_mean_caught"].values())
            and repl_equal
            and all(r["launches"][k] == v for r in ranks for k, v in exp_bwd.items())):
        fail(f"dp_tp_train_step: {res}")
    out["dp_tp_train_step"] = res
    del ranks
    gc.collect()
    torch.cuda.empty_cache()

    # -- ring_kernel_composition: one process, 32760^2 unmasked --
    t0 = time.perf_counter()
    rows = ps.ring_composition(dev)
    phase("ring_kernel_composition", rows=rows, phase_s=time.perf_counter() - t0, card=card)
    bad = [r for r in rows if not (r["within_tol"] and r["lse_max_abs_err"] <= r["lse_tol"]
                                   and r["launches"] == r["sp"])]
    if bad:
        fail(f"ring_kernel_composition: {bad}")
    out["ring_kernel_composition"] = rows

    # -- nccl_multi_gpu: a card a rank, where there are two or more --
    n = torch.cuda.device_count()
    if n < 2:
        phase("nccl_multi_gpu", ran=False, devices=n, card=card)
    else:
        t0 = time.perf_counter()
        tp = 2
        ranks = launch.run(ps.tp_denoise_rank, tp, {"tiers": ("bf16",), "model": "t2v-1.3B",
                                                   "act_scales": None},
                           backend="nccl", device="cuda", timeout_s=400)
        want = ps.one_process_block("bf16", "t2v-1.3B", dev, None)["x0"]
        tp_cos = ps.cosine(ranks[0]["bf16"]["x0"], want)
        flows = launch.run(ps.teacher_sp_rank, n, {}, backend="nccl", device="cuda",
                           timeout_s=600)
        cfg, params = ps.model_params("t2v-1.3B", None, dev)
        single = ps.teacher_flow(ps.WanDiffusion(cfg=cfg, params=params), dev).cpu()
        sp_cos = ps.cosine(flows[0]["flow"], single)
        res = {"ran": True, "devices": n, "tp_denoise_bf16_cosine": tp_cos,
               "teacher_sp": n, "teacher_sp_r": flows[0]["sp_r"], "teacher_sp_u": flows[0]["sp_u"],
               "teacher_flow_cosine_vs_one_card": sp_cos,
               "phase_s": time.perf_counter() - t0}
        phase("nccl_multi_gpu", **res, card=card)
        if not (tp_cos > 0.999 and sp_cos > 0.999):
            fail(f"nccl_multi_gpu: {res}")
        out["nccl_multi_gpu"] = res
    return out


#: the VAE split against the same card's unsplit VAE, by tier: relative
#: Frobenius error of the pixels and latents (an int8 session's frames and a
#: VAE on other cards: the int8 bar). Set from the first readings on an H100
#: 80GB HBM3 at 700 W: int8 split and unsplit are bit-equal (0.0: the s8
#: convs are exact and every other op computes a pixel alike), so its bar
#: leaves room for a few quanta only; f32 shows the split's arithmetic with
#: cuDNN in the convs. Interior halos zeroed read 0.21-0.22, so the planted
#: fault must miss the f32 and int8 bars by 10x. bf16 read 1.9e-2, the same
#: with cuDNN deterministic: cuDNN's bf16 3x3 convs at some shard forms of
#: the latent and 2x rows round 1-2 ulps otherwise (up to 7.9e-5 each on
#: equal inputs, `split_op_divergence`; every other op is bit-equal), and the
#: random VAE amplifies that (the fold, an exact rewrite, moves bf16 pixels
#: by 1.8e-2 too). So the bf16 bar is a gross check only, 4x below the
#: fault: the f32 and int8 bars and the split's bf16 convs on their own
#: inputs (VAE_SPLIT_CONV_BF16_BAR) hold the split.
VAE_SPLIT_BARS = {"f32": 1e-4, "int8": 1e-3, "bf16": 5e-2}
#: one bf16 causal conv of the VAE split into row shards (the walk's halo
#: exchange on the spliced input, then each shard's cuDNN conv) against the
#: full-height conv cut to the same rows: relative Frobenius error. Set from
#: the first readings (H100 80GB HBM3, 700 W): 3.5e-5 at most while an edge
#: shard padded a copy of its input (one-ulp flips, cuDNN deterministic
#: alike), bit-equal since it pads both sides and drops a row; interior halos
#: zeroed read 0.037 (full rows, 2 shards) to 0.18 (latent rows, 4), 37-184x
#: this bar; it holds a stream's first chunk (one frame through the last
#: temporal tap alone) too, and each cuDNN conv of a whole split decode on
#: its own inputs (`split_op_divergence`), where the shard forms at the latent
#: and 2x rows read up to 7.9e-5 (1-2 ulp flips: cuDNN picks its algorithm by
#: shape, deterministic or not) and every other op is bit-equal
VAE_SPLIT_CONV_BF16_BAR = 1e-3
#: the phase-folded decode against the unfused one in bf16 (the folded
#: weights are rounded to bf16 once more)
FUSEUP_BF16_REL_FRO_BAR = 5e-2
#: the int8 fused decode's mean abs error against the bf16 unfused decode,
#: at most this many times the unfused int8 decode's: the fold may add no
#: error of its own beyond int8's (the JAX test's absolute 0.02, held at tiny
#: dims on the CPU, does not hold at full width: the unfused int8 decode of
#: the random Wan 2.1 VAE is itself 0.027 from bf16 on an H100)
FUSEUP_INT8_ERR_RATIO_BAR = 1.2


#: the decoder ops `split_op_divergence` holds one at a time
SPLIT_TRACED_OPS = ("conv3d", "conv2d", "rms_norm_image", "attention_qkv", "attention_out")


def split_op_divergence(base, split, z) -> dict:
    """Each traced op of the VAE decoder (SPLIT_TRACED_OPS of
    models/vae.py) in the split wrapper's decode of z (its first latent,
    then two warm ones, one `decode_block` call each), held on its own
    inputs: the unsplit decode runs first and keeps every op's output; the
    split decode then runs with each shard's output of an op compared bit
    for bit with the same rows of the unsplit op's output and replaced by
    them, so that every op sees the unsplit rows as its input. Returns, per
    op, its calls, how many shard outputs differ, the largest difference,
    and the first differing calls (op, call, rows, shapes); and per form
    (op, weight shape, input shape: the conv's input rows with their halo)
    its shard outputs, how many differ and the largest relative Frobenius
    error among them."""
    import torch

    from realtime_video_tpu_torch.models import vae as vae_mod

    real = {n: getattr(vae_mod, n) for n in SPLIT_TRACED_OPS}
    want = {n: [] for n in SPLIT_TRACED_OPS}

    def decode3(vae):
        cache = None
        for i in range(3):
            _, cache = vae.decode_block(z[:, i:i + 1].to(vae.dtype), cache)

    def record(n):
        def op(*a, **k):
            y = real[n](*a, **k)
            want[n].append(y)
            return y
        return op

    at = {n: [0, 0] for n in SPLIT_TRACED_OPS}  # per op: unsplit call, row offset
    stats = {n: dict(calls=0, shard_outputs=0, differing=0, max_abs_diff=0.0)
             for n in SPLIT_TRACED_OPS}
    forms = {}  # "op w=... in=...": shard outputs, differing, largest relative error
    first = []

    def substitute(n):
        def op(*a, **k):
            y = real[n](*a, **k)
            call, off = at[n]
            w = want[n][call]
            ys, ws = (y, w) if isinstance(y, tuple) else ((y,), (w,))
            h = ys[0].shape[1]
            cut = tuple(t[:, off:off + h] for t in ws)
            same = all(torch.equal(g, c) for g, c in zip(ys, cut))
            st = stats[n]
            st["shard_outputs"] += 1
            p = a[0]
            w_ = p.get("w", p.get("w_q")) if isinstance(p, dict) else None
            key = (f"{n} w={'-' if w_ is None else list(w_.shape)} "
                   f"in={list(a[1].shape) if n.startswith('conv') else list(ys[0].shape)}")
            form = forms.setdefault(key, dict(shard_outputs=0, differing=0, max_rel_fro=0.0))
            form["shard_outputs"] += 1
            if not same:
                diff = max(float((g.float() - c.float()).abs().max()) for g, c in zip(ys, cut))
                rel = max(float((g.float() - c.float()).norm() / c.float().norm())
                          for g, c in zip(ys, cut))
                st["differing"] += 1
                st["max_abs_diff"] = max(st["max_abs_diff"], diff)
                form["differing"] += 1
                form["max_rel_fro"] = max(form["max_rel_fro"], rel)
                if len(first) < 4:
                    first.append(dict(op=n, call=call, rows=[off, off + h],
                                      out=list(ys[0].shape), max_abs_diff=diff,
                                      rel_fro_err=rel, w=None if w_ is None else list(w_.shape)))
            at[n][1] = off + h
            if at[n][1] == ws[0].shape[1]:
                at[n] = [call + 1, 0]
                st["calls"] += 1
            out = tuple(c.contiguous() for c in cut)
            return out if isinstance(y, tuple) else out[0]
        return op

    try:
        with torch.no_grad():
            for n in SPLIT_TRACED_OPS:
                setattr(vae_mod, n, record(n))
            decode3(base)
            for n in SPLIT_TRACED_OPS:
                setattr(vae_mod, n, substitute(n))
            decode3(split)
    finally:
        for n, fn in real.items():
            setattr(vae_mod, n, fn)
    return {"ops": stats, "forms": forms, "first_differing": first}


#: the kernels each 1.3B tier's session must launch
KERNEL_PATHS = {"bf16": ("window", "logit_bound", "block_causal", "add_ln_modulate",
                         "qk_norm_rope"),
                "int8": ("window", "logit_bound", "block_causal", "int8_linear", "conv3x3",
                         "conv_quantize", "add_ln_modulate", "qk_norm_rope")}
#: the server config flags of the int8 tier (calibrated and quantised on the card)
INT8_FLAGS = {"enable_int8": True, "enable_int8_dit": True, "int8_static_scales": True}
#: a warm block with the former formulas planted back must make at least
#: this many synchronising calls: the former `latent_scale` builds 2 tensors
#: from host lists at each of its 3 decodes and its re-encode, the former
#: time embedding 1 at each of its 5 DiT forwards (13 on one card)
PLANTED_SYNCS_MIN = 4


def former_latent_scale(cfg, device=None):
    """`vae.latent_scale` as it was before it kept its tensors: (mean, std)
    built from the host lists at every call, a blocking copy to the card."""
    import torch

    from realtime_video_tpu_torch.models import vae as vae_mod

    if cfg.z_dim == len(vae_mod.VAE_LATENT_MEAN):
        return (torch.tensor(vae_mod.VAE_LATENT_MEAN, dtype=torch.float32, device=device),
                torch.tensor(vae_mod.VAE_LATENT_STD, dtype=torch.float32, device=device))
    return (torch.zeros((cfg.z_dim,), dtype=torch.float32, device=device),
            torch.ones((cfg.z_dim,), dtype=torch.float32, device=device))


def former_time_embedding(dim, position):
    """`rope.sinusoidal_embedding_1d` as it was before its base became a
    Python scalar: a 0-d tensor built on the card at every call."""
    import torch

    half = dim // 2
    p = position.to(torch.float32).reshape(-1)
    inv = torch.pow(torch.tensor(10000.0, dtype=torch.float32, device=p.device),
                    -torch.arange(half, dtype=torch.float32, device=p.device) / half)
    sinusoid = p[:, None] * inv[None, :]
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


@contextlib.contextmanager
def former_sync_formulas():
    """The two former formulas planted back where the session calls them
    (`vae.latent_scale`, `wan_dit.sinusoidal_embedding_1d`): the parent
    commit's host syncs, the same values."""
    from realtime_video_tpu_torch.models import vae as vae_mod
    from realtime_video_tpu_torch.models import wan_dit

    real = vae_mod.latent_scale, wan_dit.sinusoidal_embedding_1d
    vae_mod.latent_scale, wan_dit.sinusoidal_embedding_1d = (former_latent_scale,
                                                             former_time_embedding)
    try:
        yield
    finally:
        vae_mod.latent_scale, wan_dit.sinusoidal_embedding_1d = real


def planted_sync_check(card: str, label: str, models, config) -> dict:
    """The no-sync check shown to see a sync in this run: one warm block
    (`session_syncs.warm_block_syncs`, block 2) with the former formulas
    planted back must raise under sync debug "error" and make at least
    PLANTED_SYNCS_MIN synchronising calls under "warn" (the parent commit's
    count of this case)."""
    from realtime_video_tpu_torch.tools import session_syncs as ss

    with former_sync_formulas():
        try:
            ss.warm_block_syncs(models, config, mode="error")
            raised = None
        except RuntimeError as e:
            raised = str(e).splitlines()[0]
        warn = ss.warm_block_syncs(models, config)
    row = dict(error_mode_raised=raised, warn_count=warn["count"], warn_sites=warn["sites"])
    phase("planted_sync", case=label, **row, card=card)
    if raised is None or warn["count"] < PLANTED_SYNCS_MIN:
        fail(f"planted_sync {label}: the former formulas' syncs were not seen: {row}")
    return row


#: the DiT's norm sites at the serving shapes (one warm block's forward:
#: 3 frames of 1560 tokens), t2v-1.3B and t2v-14B widths
DIT_NORM_SHAPES = (("1.3b", 4680, 3, 1536, 12), ("14b", 4680, 3, 5120, 40))
DIT_NORM_SITES = ("msa", "gated_affine", "residual_modulate", "gated_only", "qk_from_qkv",
                  "cross_q")


def bf16_ulps(got, want):
    """Elementwise |got - want| in units of want's bf16 ulp (8-bit significand)."""
    import torch

    _, exp = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), exp - 8).clamp_min(2.0 ** -126)
    return (got.float() - want.float()).abs() / ulp


def bf16_step(n, k: int):
    """n with each element moved k bf16 steps along its bit pattern (one
    neighbour for k = 1, the other for k = -1)."""
    import torch

    return (n.view(torch.int16) + k).view(torch.bfloat16)


def graph_ms(fn, n: int) -> float:
    """Mean CUDA-event time of fn over n calls captured in one CUDA graph:
    the card's time alone, without the host's launch cost between calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / n


def dit_norm_phase(card: str, dev) -> dict:
    """The DiT's norm row kernels (csrc/dit_norm_sm90.cu) against the plain
    chains of models/wan_dit.py on the card, at each site of a layer and
    the t2v-1.3B and t2v-14B widths (L 4680, 3 frames; q / k read out of
    the [L, 3D] qkv output).

    Correctness: the kernels make the chains' roundings in their order and
    sum the f32 statistics in another, so a statistic may differ in its
    last bit and move the normalised value n (bf16) by one step; the rest
    of the chain is the same arithmetic. Each element must equal the plain
    chain's, or the chain's computed from n one bf16 step up or down (for
    RoPE, either element of the pair), and 99.9% must be bit-equal, or the
    run fails. The largest difference in bf16 ulps of the output is
    reported beside: where the last add cancels (modulate's + shift, the
    affine's + bias, RoPE's difference) one step of n is several ulps of a
    small result.

    Time: the kernel's and the plain chain's CUDA-event time a call inside
    a CUDA graph (the card's time; `host_us` the host's cost of a call of
    the wrapper), beside the bytes bound (bytes / 3.35 TB/s)."""
    import torch

    from realtime_video_tpu_torch.models import wan_dit
    from realtime_video_tpu_torch.models.rope import RopeTables, rope_apply_fused
    from realtime_video_tpu_torch.ops import hopper_dit_norm as hdn

    gen = torch.Generator(device=dev).manual_seed(20)

    def rnd(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def flat(*parts):
        return torch.cat([t.reshape(-1) for t in parts if t is not None])

    out = {}
    eps = 1e-6
    for model, L, f, d, heads in DIT_NORM_SHAPES:
        dh = d // heads
        # tokens of a layer's spread, a few rows 30x louder (the stats' range)
        x = rnd((1, L, d), 1.0)
        x[:, ::97] *= 30.0
        y = rnd((1, L, d), 0.5)
        em = rnd((1, f, 6, d), 0.3, torch.float32)
        w, bias = rnd((d,), 1.0), rnd((d,), 0.2)
        q, k, _ = rnd((1, L, 3 * d), 2.0).chunk(3, dim=-1)
        qc = rnd((1, L, d), 2.0)
        wq, wk = rnd((d,), 1.0), rnd((d,), 1.0)
        rope = RopeTables.create(dh, device=dev).fused(f, 30, 52, 3)
        ones = torch.ones((d,), dtype=torch.bfloat16, device=dev)
        t_gated, t_sum = x + wan_dit.gate(y, f, em[:, :, 2]), x + y

        def modulated(t, c):  # (n, n -> the rest of the chain) of an AdaLN site
            return (wan_dit.layer_norm(t, eps=eps),
                    lambda n: wan_dit.modulate(n, f, em[:, :, c], em[:, :, c + 1]))

        def qk_tail(wt, tables):  # rms-normalised n -> * w, then RoPE
            def tail(n):
                o = (n * wt).reshape(1, L, heads, dh)
                return o if tables is None else rope_apply_fused(o, *tables)
            return tail

        def steps(n, tail, pairs):
            """The chain from n moved one step up or down (each element of a
            RoPE pair on its own)."""
            if not pairs:
                return [tail(bf16_step(n, s)) for s in (1, -1)]
            alts = []
            even = torch.zeros(d, dtype=torch.int16, device=dev)
            even[0::2] = 1
            for a in (-1, 0, 1):
                for c in (-1, 0, 1):
                    if a or c:
                        move = even * a + (1 - even) * c
                        alts.append(tail((n.view(torch.int16) + move).view(torch.bfloat16)))
            return alts

        n_msa, g_msa = modulated(x, 0)
        n_ffn, g_ffn = modulated(t_sum, 3)
        n_n3 = wan_dit.layer_norm(t_gated, eps=eps)
        n_q = wan_dit.rms_norm({"scale": ones}, q, eps=eps)
        n_k = wan_dit.rms_norm({"scale": ones}, k, eps=eps)
        n_c = wan_dit.rms_norm({"scale": ones}, qc, eps=eps)
        tq, tk, tc = qk_tail(wq, rope), qk_tail(wk, rope), qk_tail(wq, None)
        # each site: (the kernel's call, the plain chain, the one-step
        # alternatives as flat tensors, its bytes)
        sites = {
            "msa": (lambda: hdn.add_ln_modulate(x, f, shift=em[:, :, 0], scale=em[:, :, 1],
                                                eps=eps)[1],
                    lambda: wan_dit.modulate(wan_dit.layer_norm(x, eps=eps), f, em[:, :, 0],
                                             em[:, :, 1]),
                    lambda: [flat(a) for a in steps(n_msa, g_msa, False)],
                    hdn.add_ln_modulate_bytes(L, d, False, frames=f)),
            "gated_affine": (
                lambda: hdn.add_ln_modulate(x, f, y, em[:, :, 2], weight=w, bias=bias, eps=eps),
                lambda: (lambda t: (t, wan_dit.layer_norm(t, w, bias, eps=eps)))(
                    x + wan_dit.gate(y, f, em[:, :, 2])),
                lambda: [flat(t_gated, a) for a in steps(n_n3, lambda n: n * w + bias, False)],
                hdn.add_ln_modulate_bytes(L, d, True, frames=f, per_frame=1) + 4 * d),
            "residual_modulate": (
                lambda: hdn.add_ln_modulate(x, f, y, shift=em[:, :, 3], scale=em[:, :, 4],
                                            eps=eps),
                lambda: (lambda t: (t, wan_dit.modulate(wan_dit.layer_norm(t, eps=eps), f,
                                                        em[:, :, 3], em[:, :, 4])))(x + y),
                lambda: [flat(t_sum, a) for a in steps(n_ffn, g_ffn, False)],
                hdn.add_ln_modulate_bytes(L, d, True, frames=f)),
            "gated_only": (lambda: hdn.add_ln_modulate(x, f, y, em[:, :, 5], norm=False)[0],
                           lambda: x + wan_dit.gate(y, f, em[:, :, 5]),
                           lambda: [],
                           hdn.add_ln_modulate_bytes(L, d, True, False, frames=f,
                                                     per_frame=1)),
            "qk_from_qkv": (
                lambda: hdn.qk_norm_rope(q, k, wq, wk, rope, dh, eps),
                lambda: tuple(qk_tail(wt, rope)(wan_dit.rms_norm({"scale": ones}, t, eps=eps))
                              for t, wt in ((q, wq), (k, wk))),
                lambda: [flat(a, b) for a, b in zip(steps(n_q, tq, True),
                                                    steps(n_k, tk, True))]
                + [flat(a, tk(n_k)) for a in steps(n_q, tq, True)]
                + [flat(tq(n_q), b) for b in steps(n_k, tk, True)],
                hdn.qk_norm_rope_bytes(L, d, 2, dh // 2, L)),
            "cross_q": (lambda: hdn.qk_norm_rope(qc, None, wq, None, None, dh, eps)[0],
                        lambda: tc(wan_dit.rms_norm({"scale": ones}, qc, eps=eps)),
                        lambda: [flat(a) for a in steps(n_c, tc, False)],
                        hdn.qk_norm_rope_bytes(L, d, 1)),
        }
        for site in DIT_NORM_SITES:
            kern, plain, alternatives, nbytes = sites[site]
            res, ref = kern(), plain()
            got = flat(*(res if isinstance(res, tuple) else (res,)))
            want = flat(*(ref if isinstance(ref, tuple) else (ref,)))
            torch.cuda.synchronize()
            same = got.view(torch.int16) == want.view(torch.int16)
            explained = same.clone()
            for alt in alternatives():
                explained |= got.view(torch.int16) == alt.view(torch.int16)
            u = bf16_ulps(got, want)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                kern()
            host_us = (time.perf_counter() - t0) * 1e4
            ms, plain_ms = graph_ms(kern, 20), graph_ms(plain, 5)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row = dict(bit_equal_share=float(same.float().mean()),
                       unexplained=int((~explained).sum()), differing=int((~same).sum()),
                       max_bf16_ulps=float(u.max()), finite=bool(torch.isfinite(got).all()),
                       ms=ms, plain_ms=plain_ms, host_us=host_us, bound_ms=bound_ms,
                       bound_by="bytes", bandwidth_share=bound_ms / ms,
                       gb_per_s=nbytes / ms / 1e6)
            out[f"{site}_{model}"] = row
            phase("kernel", kernel="qk_norm_rope" if site in ("qk_from_qkv", "cross_q")
                  else "add_ln_modulate", case=f"{site}_{model}", rows=L, d=d, frames=f,
                  **row, card=card)
            if not (row["finite"] and row["unexplained"] == 0
                    and row["bit_equal_share"] >= 0.999):
                fail(f"dit norm {site}_{model}: {row['unexplained']} elements unexplained by "
                     f"one step of the normalised value, {row['bit_equal_share']:.5f} "
                     "bit-equal to the plain chain")
            del res, ref, got, want, same, explained, u
        del x, y, q, k, qc, t_gated, t_sum, n_msa, n_ffn, n_n3, n_q, n_k, n_c, sites
        torch.cuda.empty_cache()
    return out


def session_megafuse_phase(card: str, dev, tier: str, config, models, head_w, kernel_mods,
                           read_counts, required) -> dict:
    """The session's throughput mode (RTV_SESSION_MEGAFUSE) at t2v-1.3B
    832x480 on `models` (`tier`: "bf16" or "int8"), the DiT head random
    (`head_w`), the same seed throughout
    (`tools/session_syncs.timed_session`: frames to the host on a worker
    thread, as the server's callback does):

      * after an untimed 3-block session, four sessions of 5 blocks, the
        switch at 1, 0, 0, 1: each one's
        TTFF, block walls and warm fps on the host's clock, and per block
        the host's time to queue it (entry to return of
        `generate_block_internal`) beside the card's time between CUDA
        events at those two points; every launch count set to 0 before
        them and read after: each kernel of `required` must have launched
        and no plain version may have seen a CUDA tensor;
      * the first two sessions' latents and frames (switch 1 against 0)
        must be bit-equal, and are stated beside each mode against its own
        repeat (sessions 2 and 3 against 1 and 0);
      * one warm block (block 2, the first with the anti-drift re-encode)
        under `torch.cuda.set_sync_debug_mode("error")` (reset after) with
        the switch at 1, which must make no synchronising call, and the same
        block with the switch at 0 counted under "warn", for the record: of
        this tier's models, and on the int8 tier also of TAEHV
        (`use_taehv`) and of a VAE split into 2 row shards on this card;
        then each such block with the former formulas planted back
        (`planted_sync_check`), which must raise under "error" and make at
        least PLANTED_SYNCS_MIN synchronising calls under "warn";
      * the DiT norm kernels' launches in a warm block (block 2 of a session
        less blocks 0-1), which must be 5 forwards (the prefill and 4 steps)
        of 6 a layer and 1 for the head, with none of their calls on the
        plain chain;
      * on bf16, `sinusoidal_embedding_1d` and `latent_scale` on the card
        against the formulas they replaced (bit-equal)."""
    import torch

    from realtime_video_tpu_torch.config import load_server_config
    from realtime_video_tpu_torch.models import rope as rope_mod
    from realtime_video_tpu_torch.models import vae as vae_mod
    from realtime_video_tpu_torch.ops import hopper_dit_norm as hdn
    from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
    from realtime_video_tpu_torch.serving.models import Models
    from realtime_video_tpu_torch.serving.session import _ensure_taehv_params
    from realtime_video_tpu_torch.tools import session_syncs as ss

    t_phase = time.perf_counter()
    head = models.transformer.params["head"]["head"]
    saved, head["w"] = head["w"], head_w.to(head["w"].dtype)
    out = {}
    def compare(a, b):
        px = (a["frames"] - b["frames"]).abs()
        blocks = a["latents"].shape[1] // 3
        return dict(latents=torch.equal(a["latents"], b["latents"]),
                    frames=torch.equal(a["frames"], b["frames"]),
                    latents_max_abs_diff=float((a["latents"] - b["latents"]).abs().max()),
                    frames_max_abs_diff=float(px.max()), frames_mean_abs_diff=float(px.mean()),
                    blocks_equal=[torch.equal(a["latents"][:, 3 * i:3 * i + 3],
                                              b["latents"][:, 3 * i:3 * i + 3])
                                  for i in range(blocks)],
                    first_differing_frame=next((i for i in range(px.shape[1])
                                                if px[:, i].max() > 0), None))

    try:
        ss.timed_session(models, config, blocks=3)  # warm both kinds of block first
        for m in kernel_mods:
            m.reset_launch_counts()
        runs = [ss.timed_session(models, config, megafuse=mf, keep_frames=True)
                for mf in ("1", "0", "0", "1")]
        launches, plain = read_counts()
        plain = dict(plain, **{f"dit_norm_{k}": v for k, v in hdn.PLAIN_ON_CUDA.items()})
        # the switch at 1 against 0, then each mode against its own repeat
        equal = compare(runs[0], runs[1])
        repeats = {"streamed": compare(runs[1], runs[2]), "fused": compare(runs[0], runs[3])}
        timing = [{k: r[k] for k in ("megafuse", "ttff_ms", "block_ms", "fps_warm", "host_ms",
                                     "device_ms", "frames_per_callback")} for r in runs]
        finite = bool(all(torch.isfinite(r["frames"]).all() for r in runs))
        frames_n = [r["frames"].shape[1] for r in runs[:2]]
        del runs
        out.update(equal=equal, repeats=repeats, sessions=timing, launches=launches,
                   plain_on_cuda=plain)
        phase("session_megafuse", tier=tier, sessions=timing, equal=equal, repeats=repeats,
              frames=frames_n, finite=finite, launches=launches, plain_on_cuda=plain, card=card)
        missing = [k for k in required if launches.get(k, 0) <= 0]
        if missing or any(plain.values()) or not finite or frames_n != [54, 54]:
            fail(f"session_megafuse {tier}: kernels not launched {missing}, plain on CUDA "
                 f"{plain}, finite {finite}, frames {frames_n}")
        if timing[0]["frames_per_callback"] != [2, 4] + [12] * 4 or \
                timing[1]["frames_per_callback"] != [2, 4] + [4] * 12:
            fail(f"session_megafuse {tier}: frames per callback "
                 f"{[t['frames_per_callback'] for t in timing[:2]]}")
        if not (equal["latents"] and equal["frames"]):
            fail(f"session_megafuse {tier}: the switch at 1 and at 0 differ: {equal}")

        cases = {tier: (models, config)}
        if tier == "int8":
            vae = models.vae_decoder
            split = VAEWrapper(vae.cfg, vae.params, mesh=[dev, dev], dit_device=dev)
            cases["split2"] = (Models(models.text_encoder, models.transformer, models.pipeline,
                                      split, split), config)
            _ensure_taehv_params(models)
            cases["taehv"] = (models, load_server_config(model_name="t2v-1.3B",
                                                         num_frame_per_block=3,
                                                         timestep_shift=5.0, use_taehv=True,
                                                         **INT8_FLAGS))
        syncs = {}
        for case, (m, cfg) in cases.items():
            row = {}
            try:
                row["error_mode"] = ss.warm_block_syncs(m, cfg, megafuse="1", mode="error")
                row["error_mode_raised"] = None
            except RuntimeError as e:
                row["error_mode_raised"] = str(e).splitlines()[0]
                row["warn_megafuse_1"] = ss.warm_block_syncs(m, cfg, megafuse="1")
            row["warn_megafuse_0"] = ss.warm_block_syncs(m, cfg, megafuse="0")
            phase("session_megafuse_syncs", case=case, **row, card=card)
            row["planted"] = planted_sync_check(card, case, m, cfg)
            syncs[case] = row
        out["syncs"] = syncs
        counts = {}
        for upto in (1, 2):  # blocks 0..upto, the last one counted by difference
            hdn.reset_launch_counts()
            ss.warm_block_syncs(models, config, megafuse="1", block=upto)
            counts[upto] = (dict(hdn.LAUNCHES), dict(hdn.PLAIN_ON_CUDA))
        layers = models.transformer.cfg.num_layers
        warm = {k: counts[2][0][k] - counts[1][0][k] for k in hdn.LAUNCHES}
        want = {"add_ln_modulate": 5 * (4 * layers + 1), "qk_norm_rope": 5 * 2 * layers}
        out["dit_norm_launches"] = dict(warm_block=warm, expected=want,
                                        plain_on_cuda=counts[2][1])
        phase("session_dit_norm_launches", tier=tier, **out["dit_norm_launches"], card=card)
        if warm != want or any(counts[2][1].values()):
            fail(f"session_megafuse {tier}: DiT norm launches a warm block {warm}, want "
                 f"{want}; plain chain on CUDA {counts[2][1]}")
        raised = {c: r["error_mode_raised"] for c, r in syncs.items() if r["error_mode_raised"]}
        if raised:
            fail(f"session_megafuse: a warm block made a synchronising call: {raised}")
        if tier == "bf16":
            t = torch.tensor([[999.0, 937.5, 833.25]], device=dev)
            emb_equal = torch.equal(rope_mod.sinusoidal_embedding_1d(256, t),
                                    former_time_embedding(256, t))
            vcfg = models.vae_decoder.cfg
            scale_equal = all(torch.equal(a, b) for a, b in zip(
                vae_mod.latent_scale(vcfg, dev), former_latent_scale(vcfg, dev)))
            out["formulas_equal"] = dict(sinusoidal_embedding_1d=emb_equal,
                                         latent_scale=scale_equal)
            phase("session_megafuse_formulas", **out["formulas_equal"], card=card)
            if not (emb_equal and scale_equal):
                fail(f"session_megafuse: a repaired formula changed its values: "
                     f"{out['formulas_equal']}")
    finally:
        head["w"] = saved
    out["phase_s"] = time.perf_counter() - t_phase
    phase("session_megafuse_done", tier=tier, phase_s=out["phase_s"], card=card)
    return out


def vae_phases(card: str, dev, config, models, request, head_w, kernel_mods,
               phases=("split", "fuseup", "multi_gpu")) -> dict:
    """The VAE's placement, row split and upsample fold at 832x480 (480x832
    pixels, latents 60x104), on the int8 tier's models (`config`, `models`:
    the static embedding) and the bf16 VAE of `load_vae`:

      * `vae_split_one_card`: the Wan 2.1 VAE in bf16 and int8 (static
        scales) split by rows into 2 and 4 shards, every shard on this card
        (`VAEWrapper(mesh=[dev] * n)`), and in f32 into 2: three latents
        (the first chunk and two warm ones), a T = 1 encode and a 1 + 4
        encode against the unsplit VAE (VAE_SPLIT_BARS); the conv kernel's
        launches at the shard shapes, each distinct shard form held against
        its plain version (int32 sums equal, the fused dequantise
        bit-equal) and timed beside its bound; interior halos zeroed (the
        planted fault) must miss the f32 and int8 bars by 10x; a 3-block
        int8 session whose VAE is the 2-shard wrapper against the unsplit
        session's frames. Shards that share a card gain nothing: the times
        are for the record only;
      * `vae_fuseup`: the phase-folded decode (`fuse_decoder_upsample`)
        against the unfused one in bf16 (cuDNN; FUSEUP_BF16_REL_FRO_BAR) and
        in int8 (its mean error against the bf16 decode beside the unfused
        int8's, FUSEUP_INT8_ERR_RATIO_BAR), the fused convs' forms (4x the
        output channels) held against the plain version, and a warm
        latent's decode timed fused against unfused (CUDA events, in turns);
      * `vae_multi_gpu`: with two or more cards, a session whose VAE is
        pinned to cuda:1 (pixels there, latents on the DiT's card) and one
        whose VAE is split over cuda:1..N-1 against the one-card session,
        with their walls, each after a first, cold session; then one
        card's, the pinned and the split layout's 5-block sessions
        timed as the server meets them (`tools/session_syncs.timed_session`)
        with the switch at 1 and at 0, and a warm block of the pinned and
        the split layout counted under sync debug "warn", which must find
        no synchronising call, and must find the former formulas' when
        they are planted back (`planted_sync_check`); on one card
        {"ran": false}.
    `phases` runs a subset (a probe of the multi-card phase alone)."""
    import torch

    from realtime_video_tpu_torch.models import vae as vae_mod
    from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
    from realtime_video_tpu_torch.ops import hopper_conv as hc
    from realtime_video_tpu_torch.serving.models import Models, load_vae
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession
    from realtime_video_tpu_torch.tools import session_syncs
    from realtime_video_tpu_torch.utils.device import on_card

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(15)
    z = torch.randn((1, 3, 16, 60, 104), generator=gen, device=dev).to(torch.bfloat16)
    px = (torch.rand((1, 5, 3, 480, 832), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)

    def reset():
        for m in kernel_mods:
            m.reset_launch_counts()

    def counts():
        return dict(hc.LAUNCHES, **hc.PREPASS_LAUNCHES), dict(hc.PLAIN_ON_CUDA)

    def sync_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def err(got, want):
        want = want.float().to(got.device)
        d = got.float() - want
        return {"max_abs_err": float(d.abs().max()), "rel_fro_err": float(d.norm() / want.norm())}

    @contextlib.contextmanager
    def walk_patched(name, fn):
        """A planted fault: vae._Walk's method `name` replaced by fn."""
        real = getattr(vae_mod._Walk, name)
        setattr(vae_mod._Walk, name, fn)
        try:
            yield
        finally:
            setattr(vae_mod._Walk, name, real)

    def no_halo():
        """Interior halos zeroed: every shard pads its conv where its
        neighbours' rows belong."""
        return walk_patched("halo", lambda self, xs, above, below:
                            [(x, (above, below)) for x in xs])

    @contextlib.contextmanager
    def cudnn_deterministic():
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved

    def conv_rows(p, x, cache, n):
        """One causal conv through the walk: x [T, H, W, C] and its cache
        [2, H, W, C] (None: a stream's first chunk, whose one frame runs the
        last temporal tap only) cut into n row shards (n = 1: the unsplit
        conv), the shards' outputs joined."""
        caches = None if cache is None else [(c,) for c in cache.chunk(n, dim=1)]
        ys = vae_mod.causal_conv3d(vae_mod._Walk(caches, n), [p] * n, list(x.chunk(n, dim=1)))
        return torch.cat(ys, dim=1)

    def split_conv_bf16(params):
        """The split's bf16 convs one at a time: the decoder's first middle
        conv at the latent rows (384 channels, 60 x 104) and its last full
        resolution conv (96 channels, 480 x 832), a warm chunk (the three
        temporal taps) and a stream's first chunk (the last tap alone) each,
        split into 2 and 4 shards against the unsplit conv
        (VAE_SPLIT_CONV_BF16_BAR), with cuDNN as it runs and deterministic,
        and interior halos zeroed."""
        rows = []
        dec = params["decoder"]
        for (name, p, (h, w)), chunk in itertools.product(
                (("middle_res1.conv1", dec["middle_res1"]["conv1"], (60, 104)),
                 ("upsamples[-1].conv1", dec["upsamples"][-1]["conv1"], (480, 832))),
                ("warm", "first")):
            c = p["w"].shape[3]
            x = torch.randn((1, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
            cache = (torch.randn((2, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
                     if chunk == "warm" else None)
            want = conv_rows(p, x, cache, 1)
            for n in (2, 4):
                row = dict(conv=name, chunk=chunk, x=[1, h, w, c], shards=n,
                           **err(conv_rows(p, x, cache, n), want))
                with cudnn_deterministic():
                    row["cudnn_deterministic"] = err(conv_rows(p, x, cache, n),
                                                     conv_rows(p, x, cache, 1))
                with no_halo():
                    row["no_halo"] = err(conv_rows(p, x, cache, n), want)
                row["bar"] = VAE_SPLIT_CONV_BF16_BAR
                row["fault_times_the_bar"] = row["no_halo"]["rel_fro_err"] / row["bar"]
                rows.append(row)
        return rows

    def guard_us(guard):
        """Host microseconds of a device guard entered and left around a
        launch on the current card (`guard(t)`), the mean of 20000."""
        t = torch.empty(1, device=dev)
        for _ in range(1000):
            with guard(t):
                pass
        t0 = time.perf_counter()
        for _ in range(20000):
            with guard(t):
                pass
        return (time.perf_counter() - t0) / 20000 * 1e6

    def decode3(vae):
        """The first chunk, then two warm chunks, a latent each (in the
        VAE's dtype: it computes in its input's)."""
        out, cache = [], None
        for i in range(3):
            p, cache = vae.decode_block(z[:, i:i + 1].to(vae.dtype), cache)
            out.append(p)
        return torch.cat(out, dim=1), cache

    def encodes(vae):
        """A fresh T = 1 encode (the re-encode) and a fresh 1 + 4."""
        return torch.cat([vae.encode_stream(px[:, :1].to(vae.dtype))[0],
                          vae.encode_stream(px.to(vae.dtype))[0]], dim=1)

    def recorded(fn):
        """(fn(), {conv form: launches}): each conv launch's (x shape, w
        shape, stride, padding)."""
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

    def hold(form):
        """A conv form held against the plain version on random s8
        operands (int32 sums equal, fused dequantise bit-equal) and timed
        beside its bound."""
        (t, h, w, c), ws, st, pad = form
        kt, co = ws[0], ws[-1]
        x = hc.pad_channels(torch.randint(-127, 128, (t, h, w, c), generator=gen, device=dev,
                                          dtype=torch.int8))
        wt = hc.k_major(torch.randint(-127, 128, (kt, 3, 3, c, co), generator=gen, device=dev,
                                      dtype=torch.int8))
        scale = torch.rand((co,), generator=gen, device=dev) * 2e-3 + 1e-3
        a_scale = torch.tensor(2.0 / 127.0, device=dev)
        bq = torch.randn((co,), generator=gen, device=dev).to(torch.bfloat16)
        want = hc.conv3x3_plain(x, wt, st, pad)
        got = hc.conv3x3_dequant(x, wt, a_scale, scale, bq, st, pad)
        want_dq = hc.dequantize_plain(want, a_scale, scale, bq, torch.bfloat16)
        row = dict(x=[t, h, w, c], w=list(ws), stride=list(st), padding=[list(p) for p in pad],
                   equal_int32=torch.equal(hc.conv3x3(x, wt, st, pad), want),
                   dequant_bit_equal=torch.equal(got.view(torch.int16),
                                                 want_dq.view(torch.int16)),
                   ms=event_ms(lambda: hc.conv3x3_dequant(x, wt, a_scale, scale, bq, st, pad),
                               5))
        row["bound_ms"], row["bound_by"] = bound(
            hc.conv3x3_bytes(x.shape, wt.shape, st, pad, in_bytes=1, out_bytes=2, bias=True),
            hc.conv3x3_ops(x.shape, wt.shape, st, pad), "int8")
        return row

    def session(vae, devices_seen=None):
        """A direct 3-block session (the random head) with `vae`: (frames,
        latents, {"wall_ms": the 3 blocks to a sync of every card, "block_ms":
        host stamps as each block returns, no sync between them, so a VAE on
        its own card may still be decoding}."""
        m = Models(models.text_encoder, models.transformer, models.pipeline, vae, vae)
        frames, stamps = [], []

        def on_frame(p, ids, ev):
            frames.append(p.float())
            if devices_seen is not None:
                devices_seen.add(str(p.device))

        head = models.transformer.params["head"]["head"]
        saved = head["w"]
        head["w"] = head_w.to(saved.dtype)
        try:
            s = GenerationSession(GenerateParams(**request), config, models=m,
                                  frame_callback=on_frame)
            sync_all()
            t0 = time.perf_counter()
            for _ in range(3):
                s.generate_block_internal(m)
                stamps.append(time.perf_counter())
            sync_all()
            times = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                     "block_ms": [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]}
        finally:
            head["w"] = saved
        return torch.cat(frames, dim=1), s.all_latents.float(), times

    vaes = {"bf16": load_vae({}, dev, seed=1), "int8": models.vae_decoder}
    f32 = VAEWrapper(vaes["bf16"].cfg, tree_to(vaes["bf16"].params, dev, torch.float32))
    out = {"split": {}, "shard_forms": [], "launches": {}}
    shard_forms = {}
    with torch.no_grad():
        reset()
        one = session(vaes["int8"])  # the one-card session the others are held to
        # every counted launch passes one device guard in its binding
        # (`on_card`): its host cost a block, beside the block's time and
        # that of entering `torch.cuda.device` at every launch
        per_block = sum(sum(c.values()) for m in kernel_mods
                        for c in (m.LAUNCHES, getattr(m, "PREPASS_LAUNCHES", {}))) / 3
        g_us = guard_us(on_card)
        d_us = guard_us(lambda t: torch.cuda.device(t.device))
        out["device_guard"] = dict(us_per_on_card=g_us, us_per_cuda_device=d_us,
                                   launches_per_block=per_block,
                                   on_card_ms_per_block=g_us * per_block / 1e3,
                                   cuda_device_ms_per_block=d_us * per_block / 1e3,
                                   block_ms=one[2]["block_ms"])
        # the same session's wall with each guard in the bindings, in turns:
        # none (the bindings before the guard), `on_card`, and
        # `torch.cuda.device` entered at every launch
        guards = {"none": lambda t: contextlib.nullcontext(), "on_card": on_card,
                  "cuda_device": lambda t: torch.cuda.device(t.device)}
        walls = {k: [] for k in guards}
        for k in ("none", "on_card", "cuda_device", "cuda_device", "on_card", "none"):
            saved = [m.on_card for m in kernel_mods]
            for m in kernel_mods:
                m.on_card = guards[k]
            try:
                walls[k].append(session(vaes["int8"])[2]["wall_ms"])
            finally:
                for m, g in zip(kernel_mods, saved):
                    m.on_card = g
        out["device_guard"]["session_wall_ms"] = walls
        phase("device_guard", **out["device_guard"], card=card)

        # ---- vae_split_one_card ----
        tiers = dict(vaes, f32=f32) if "split" in phases else {}
        for tier, base in tiers.items():
            want_px, c1 = decode3(base)
            want_z = encodes(base)
            base_ms = event_ms(lambda: base.decode_block(z[:, 1:2].to(base.dtype), c1), 3)
            for n in (2,) if tier == "f32" else (2, 4):
                split = VAEWrapper(base.cfg, base.params, mesh=[dev] * n)
                reset()
                ((got_px, s1), got_z), forms = recorded(lambda: (decode3(split), encodes(split)))
                torch.cuda.synchronize()
                launches, plain = counts()
                row = dict(pixels=err(got_px, want_px), latents=err(got_z, want_z),
                           pixel_shape=list(got_px.shape), launches=launches,
                           plain_on_cuda=plain, unsplit_warm_latent_ms=base_ms,
                           split_warm_latent_ms=event_ms(
                               lambda: split.decode_block(z[:, 1:2].to(split.dtype), s1), 3))
                if tier == "int8":
                    for f, k in forms.items():
                        shard_forms[f] = shard_forms.get(f, 0) + k
                    out["launches"][f"sp{n}"] = launches
                out["split"][f"{tier}_sp{n}"] = row
                phase("vae_split_one_card", tier=tier, shards=n, **row, card=card)
                ok = (row["pixels"]["rel_fro_err"] <= VAE_SPLIT_BARS[tier]
                      and row["latents"]["rel_fro_err"] <= VAE_SPLIT_BARS[tier]
                      and tuple(got_px.shape) == (1, 9, 3, 480, 832)
                      and bool(torch.isfinite(got_px).all()) and not any(plain.values()))
                if tier == "int8" and not (launches["conv3x3"] > 0
                                           and launches["conv3x3_temporal"] > 0
                                           and launches["conv_quantize"] > 0):
                    ok = False
                if not ok:
                    fail(f"vae_split_one_card {tier} sp{n}: {row}")
                if n == 2:  # the planted fault: interior halos zeroed
                    with no_halo():
                        bad = err(decode3(split)[0], want_px)
                    bar = VAE_SPLIT_BARS[tier]
                    held = tier != "bf16"  # bf16: held conv by conv below
                    caught = bad["rel_fro_err"] >= 10 * bar
                    phase("planted_fault", case=f"vae_split_{tier}_sp2", fault="no_halo",
                          **bad, bar=bar, times_the_bar=bad["rel_fro_err"] / bar,
                          held=held, caught=caught)
                    if held and not caught:
                        fail(f"the VAE split's check passes interior halos zeroed: {bad}")
                    if tier == "bf16":
                        with cudnn_deterministic():
                            det = err(decode3(split)[0], decode3(base)[0])
                        out["split"]["bf16_sp2"]["cudnn_deterministic"] = det
                        phase("vae_split_one_card", tier=tier, shards=n,
                              cudnn_deterministic=det, card=card)
                        # each op on its own inputs: only cuDNN's convs may
                        # differ, each within the per-conv bar; zeroed halos
                        # must miss it by 10x
                        div = split_op_divergence(base, split, z)
                        with no_halo():
                            planted = split_op_divergence(base, split, z)
                        worst = max(f["max_rel_fro"] for f in planted["forms"].values())
                        div["no_halo_max_rel_fro"] = worst
                        out["split"]["bf16_sp2"]["op_divergence"] = div
                        phase("vae_split_op_divergence", tier=tier, shards=n, **div,
                              bar=VAE_SPLIT_CONV_BF16_BAR, card=card)
                        over = {k: f for k, f in div["forms"].items() if f["differing"] and (
                            not k.startswith("conv")
                            or f["max_rel_fro"] > VAE_SPLIT_CONV_BF16_BAR)}
                        if over or worst < 10 * VAE_SPLIT_CONV_BF16_BAR:
                            fail(f"the bf16 split's ops on their own inputs: {over}; zeroed "
                                 f"halos {worst}")
                del split
        if "split" in phases:
            out["split_conv_bf16"] = split_conv_bf16(vaes["bf16"].params)
            for row in out["split_conv_bf16"]:
                phase("vae_split_conv_bf16", **row, card=card)
                if not (row["rel_fro_err"] <= row["bar"]
                        and row["no_halo"]["rel_fro_err"] >= 10 * row["bar"]):
                    fail(f"a bf16 conv split into row shards: {row}")
        if "split" in phases:
            for form in sorted(shard_forms):
                row = dict(hold(form), launches=shard_forms[form])
                out["shard_forms"].append(row)
                phase("kernel", kernel="conv3x3", case="vae_shard_form", **row, card=card)
                if not (row["equal_int32"] and row["dequant_bit_equal"]):
                    fail(f"conv shard form {row}: kernel disagrees with its plain version")

            sp2 = session(VAEWrapper(vaes["int8"].cfg, vaes["int8"].params, mesh=[dev] * 2))
            res = dict(frames=err(sp2[0], one[0]), latents=err(sp2[1], one[1]),
                       frame_count=sp2[0].shape[1], unsplit=one[2], sp2=sp2[2])
            out["session_sp2"] = res
            phase("vae_split_one_card", session="3-block int8 session, VAE sp 2", **res,
                  phase_s=time.perf_counter() - t_phase, card=card)
            if not (res["frames"]["rel_fro_err"] <= VAE_SPLIT_BARS["int8"]
                    and res["latents"]["rel_fro_err"] <= VAE_SPLIT_BARS["int8"]
                    and res["frame_count"] == 30):
                fail(f"the session with a split VAE does not give the unsplit frames: {res}")

        # ---- vae_fuseup ----
        if "fuseup" in phases:
            t_fuse = time.perf_counter()
            os.environ["RTV_VAE_FUSEUP"] = "1"
            try:
                fused = {"bf16": VAEWrapper(vaes["bf16"].cfg, vaes["bf16"].params),
                         "int8": load_vae(config, dev, seed=1)}
            finally:
                os.environ.pop("RTV_VAE_FUSEUP")
            float_px = decode3(vaes["bf16"])[0]
            fres = {}
            for tier in ("bf16", "int8"):
                reset()
                ((got_px, fc1), forms) = recorded(lambda: decode3(fused[tier]))
                torch.cuda.synchronize()
                launches, plain = counts()
                (want_px, uc1), unfused_forms = recorded(lambda: decode3(vaes[tier]))
                row = dict(vs_unfused=err(got_px, want_px), launches=launches,
                           plain_on_cuda=plain)
                if tier == "int8":
                    row["mean_abs_err_vs_bf16"] = float((got_px - float_px).abs().mean())
                    row["unfused_mean_abs_err_vs_bf16"] = float((want_px - float_px).abs().mean())
                    # each folded conv (the forms only the fused decode launches:
                    # 4x Co at the low resolution), and beside it the unfused
                    # conv it replaces (Co at twice the rows and columns: the
                    # same operations)
                    row["fused_forms"] = []
                    for f, k in sorted(forms.items()):
                        (t, h, w, c), ws, st, pad = f
                        if f not in unfused_forms:
                            plain_form = ((t, 2 * h, 2 * w, c), ws[:-1] + (ws[-1] // 4,), st,
                                          pad)
                            row["fused_forms"].append(
                                dict(hold(f), launches=k, unfused=hold(plain_form)))
                turns = [event_ms(lambda: vaes[tier].decode_block(z[:, 1:2], uc1), 3),
                         event_ms(lambda: fused[tier].decode_block(z[:, 1:2], fc1), 3),
                         event_ms(lambda: fused[tier].decode_block(z[:, 1:2], fc1), 3),
                         event_ms(lambda: vaes[tier].decode_block(z[:, 1:2], uc1), 3)]
                row["unfused_warm_latent_ms"], row["fused_warm_latent_ms"] = \
                    (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                fres[tier] = row
                phase("vae_fuseup", tier=tier, **row, card=card)
                ok = tuple(got_px.shape) == (1, 9, 3, 480, 832) and not any(plain.values())
                if tier == "bf16":
                    ok = ok and row["vs_unfused"]["rel_fro_err"] <= FUSEUP_BF16_REL_FRO_BAR
                else:
                    ok = (ok and row["mean_abs_err_vs_bf16"]
                          <= FUSEUP_INT8_ERR_RATIO_BAR * row["unfused_mean_abs_err_vs_bf16"]
                          and row["fused_forms"] and launches["conv3x3"] > 0
                          and all(r["equal_int32"] and r["dequant_bit_equal"]
                                  for f in row["fused_forms"] for r in (f, f["unfused"])))
                if not ok:
                    fail(f"vae_fuseup {tier}: {row}")
            fres["phase_s"] = time.perf_counter() - t_fuse
            out["fuseup"] = fres
            del fused

        # ---- vae_multi_gpu ----
        if "multi_gpu" in phases:
            n_cards = torch.cuda.device_count()
            if n_cards < 2:
                phase("vae_multi_gpu", ran=False, devices=n_cards, card=card)
                out["multi_gpu"] = {"ran": False, "devices": n_cards}
            else:
                t_multi = time.perf_counter()
                base = vaes["int8"]
                seen = set()
                pinned = VAEWrapper(base.cfg, base.params, device=torch.device("cuda", 1),
                                    dit_device=dev)
                encoded_on = set()
                encode = pinned.encode_stream

                def spy_encode(*a):
                    z_, c_ = encode(*a)
                    encoded_on.add(str(z_.device))
                    return z_, c_

                pinned.encode_stream = spy_encode
                # each layout twice: a fresh card's first session pays its
                # cold start (library handles, kernel loads, allocator growth);
                # the second is the steady one, as after the server's warm-up
                cold = session(pinned)
                got = session(pinned, seen)
                res = dict(devices=n_cards, pinned_frames=err(got[0], one[0]),
                           pinned_latents=err(got[1], one[1]),
                           pinned_cold_frames=err(cold[0], one[0]), frames_on=sorted(seen),
                           reencoded_latents_on=sorted(encoded_on), one_card=one[2],
                           pinned=got[2], pinned_cold_wall_ms=cold[2]["wall_ms"])
                ok = (seen == {"cuda:1"} and encoded_on == {str(dev)}
                      and max(res["pinned_frames"]["rel_fro_err"],
                              res["pinned_cold_frames"]["rel_fro_err"]) <= VAE_SPLIT_BARS["int8"])
                if n_cards >= 3:
                    cards = [torch.device("cuda", i) for i in range(1, n_cards)]
                    split = VAEWrapper(base.cfg, base.params, mesh=cards, dit_device=dev)
                    cold = session(split)
                    spl = session(split)
                    res.update(split_cards=[str(c) for c in cards],
                               split_frames=err(spl[0], one[0]), split=spl[2],
                               split_cold_wall_ms=cold[2]["wall_ms"])
                    ok = ok and res["split_frames"]["rel_fro_err"] <= VAE_SPLIT_BARS["int8"]
                # each layout's 5-block session as the server meets it (frames
                # to the host on a worker thread), the switch at 1 and at 0
                layouts = {"one_card": vaes["int8"], "pinned": pinned}
                if n_cards >= 3:
                    layouts["split"] = split
                res["timed"] = {}
                head = models.transformer.params["head"]["head"]
                saved = head["w"]
                head["w"] = head_w.to(saved.dtype)
                try:
                    for (label, v), mf in itertools.product(layouts.items(), ("1", "0")):
                        r = session_syncs.timed_session(
                            Models(models.text_encoder, models.transformer, models.pipeline,
                                   v, v), config, megafuse=mf)
                        res["timed"][f"{label}_megafuse{mf}"] = {
                            k: r[k] for k in ("ttff_ms", "block_ms", "fps_warm", "host_ms",
                                              "device_ms")}
                    # a warm block with the VAE on other cards (the copies to
                    # and from them included) must make no synchronising call
                    res["syncs"] = {
                        label: session_syncs.warm_block_syncs(
                            Models(models.text_encoder, models.transformer,
                                   models.pipeline, v, v), config)
                        for label, v in layouts.items() if label != "one_card"}
                    # ... and the same count sees the former formulas' syncs
                    # there
                    res["planted"] = {
                        label: planted_sync_check(
                            card, f"vae_{label}", Models(models.text_encoder,
                                                         models.transformer, models.pipeline,
                                                         v, v), config)
                        for label, v in layouts.items() if label != "one_card"}
                finally:
                    head["w"] = saved
                ok = ok and not any(r["count"] for r in res["syncs"].values())
                res["phase_s"] = time.perf_counter() - t_multi
                out["multi_gpu"] = dict(res, ran=True)
                phase("vae_multi_gpu", ran=True, **res, card=card)
                if not ok:
                    fail(f"vae_multi_gpu: {res}")
    out["phase_s"] = time.perf_counter() - t_phase
    del vaes
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
    from realtime_video_tpu_torch.generators import WanI2V, WanT2V
    from realtime_video_tpu_torch.models import clip as clip_mod
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
    from realtime_video_tpu_torch.ops import hopper_dit_norm as hdn
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
    from realtime_video_tpu_torch.serving.models import (
        load_all,
        load_taehv,
        load_transformer,
        load_vae,
    )
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession
    from realtime_video_tpu_torch.solvers import make_solver
    from realtime_video_tpu_torch.utils.tokenizer import FallbackTokenizer

    # comparisons below are in full f32 on the plain side: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernel_mods = (hk, hm, hc, hdn)

    def read_counts():
        """(launches, plain-on-CUDA counts). The DiT norm kernels have no
        backward, so training takes their plain chains on a card by design:
        their PLAIN_ON_CUDA is left out here and held at 0 where a session
        serves (`session_megafuse_phase`)."""
        launches = {k: v for m in kernel_mods for k, v in m.LAUNCHES.items()}
        launches.update(hk.PREPASS_LAUNCHES)
        launches.update(hc.PREPASS_LAUNCHES)
        return launches, {k: v for m in kernel_mods if m is not hdn
                          for k, v in m.PLAIN_ON_CUDA.items()}

    # ---- phase 1: device and kernel builds ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    sources = [*hk.SOURCES, hm.SOURCE, hc.SOURCE, hdn.SOURCE]
    archived = [src for src in (*EARLIER_SOURCES, BWD_EARLIER) if src.exists()]
    t0 = time.perf_counter()
    libs = cuda_build.build_all(sources + archived)
    build_s = time.perf_counter() - t0
    earlier = load_earlier(libs)
    earlier_bwd = load_earlier_backward(libs)
    sass = {libs[src].name: sass_counts(libs[src], cuda_build.nvcc()) for src in sources}
    bwd_log = cuda_build.log_path(libs[hk.BWD_SOURCE])
    bwd_ptxas = ({name: use for name, use in cuda_build.ptxas_usage(bwd_log.read_text()).items()
                  if "attn_bwd_" in name} if bwd_log.exists() else None)
    jpeg_codec = "native libjpeg (native/frame_codec.cpp)" if native.available() else "PIL"
    print(f"JPEG codec: {jpeg_codec}", flush=True)
    phase("device", card=card, kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, kernel_build_s=build_s, jpeg_codec=jpeg_codec,
          libraries=[libs[src].name for src in sources],
          archived_earlier_kernels=[src.name for src in archived], sass=sass,
          backward_ptxas=bwd_ptxas,
          tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
          tf32_cudnn=torch.backends.cudnn.allow_tf32)
    for src, ops in ((hk.SM90_SOURCE, ("HGMMA", "IGMMA", "UTMALDG")),
                     (hk.BWD_SOURCE, ("HGMMA", "UTMALDG")),
                     (hm.SOURCE, ("IGMMA", "UTMALDG")),
                     (hc.SOURCE, ("HGMMA", "IGMMA", "UTMALDG"))):
        counts = sass[libs[src].name]
        if not all(counts[op] > 0 for op in ops):
            fail(f"{src.name}: no {ops} in its SASS: {counts}")
    if sass[libs[hk.BWD_SOURCE].name]["HMMA"]:
        fail(f"{hk.BWD_SOURCE.name}: mma.sync (HMMA) in its SASS: "
             f"{sass[libs[hk.BWD_SOURCE].name]}")
    # the backward's five kernels (the pre-pass, and the dQ and dK/dV passes
    # in their window / block-causal and teacher-forcing instantiations),
    # each with 0 spill bytes (a build that was
    # reused has no report: then nothing is read)
    if bwd_ptxas is not None and (len(bwd_ptxas) != 5 or any(
            use.get("spill_store_bytes", 1) or use.get("spill_load_bytes", 1)
            for use in bwd_ptxas.values())):
        fail(f"{hk.BWD_SOURCE.name}: ptxas reports spills or a missing kernel: {bwd_ptxas}")

    # ---- phase 2: kernels against their plain versions ----
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def rint8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    cuda_ms = event_ms

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

    # -- K1 and K2-int8 at the i2v image cross-attention's shape: 32760
    # queries against the 257 CLIP tokens, i2v-14B's 40 heads, the first key
    # length that is no multiple of the 64- and 128-row tiles (the last
    # 128-row K tile holds 1 live row; K2-int8's one 384-row mean segment
    # counts 127 pad rows). Held on the two row ranges, the whole K/V; "ms"
    # is the kernel alone (K1) or the route (K2-int8), "route_ms" K1's
    # route; library_ms bf16 SDPA flash. Planted faults: the window's last
    # column (the lone live row of the last tile) dropped, and for K1 the
    # last ring stages filled with the previous tile.
    image_cross = {}
    lk_img, nh = 257, 40
    q = hk.prescale(rnd((1, tl, nh, hd)), hd ** -0.5)
    k, v = rnd((1, lk_img, nh, hd)), rnd((1, lk_img, nh, hd))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flop = hk.window_flops(tl, 0, lk_img, nh, hd)
    io_bytes = 2.0 * nh * hd * (2 * tl + 2 * lk_img)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=inv), 10)
    maxima = hk.logit_bound_maxima(q, k, inv)
    for name, route in (("image_cross_257_14b", "window"),
                        ("image_cross_257_14b_int8qk", "window_int8qk")):
        int8 = route == "window_int8qk"
        plain_fn = hk.window_attention_int8qk_plain if int8 else hk.window_attention_plain
        kern = lambda: hk.window_attention(q, k, v, 0, lk_img, scale=inv,  # noqa: E731
                                           route=route)
        got = [kern()[:, a:b] for a, b in row_ranges]
        want = [plain_fn(q[:, a:b], k, v, 0, lk_img, scale=inv) for a, b in row_ranges]
        torch.cuda.synchronize()
        res = hk.agreement(torch.cat(got, dim=1), torch.cat(want, dim=1))
        per_range = {f"rows_{a}_{b}": hk.agreement(g, w)["rel_fro_err"]
                     for (a, b), g, w in zip(row_ranges, got, want)}
        route_ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(lambda: plain_fn(q[:, :1024], k, v, 0, lk_img, scale=inv), 3)
        faults = {"hi-1": lambda: hk.window_attention(q, k, v, 0, lk_img - 1, scale=inv,
                                                      route=route)}
        if int8:
            seg = hk.segment_rows(lk_img)
            extra = hk.quanta_agreement(hk.int8_qk_prepass(q, k, seg, inv),
                                        hk.int8_qk_prepass_plain(q, k, seg, inv))
            extra["quanta_within_tol"] = extra.pop("within_tol")
            extra.update(ms=route_ms, segment_rows=seg, bf16_route_ms=cuda_ms(
                lambda: hk.window_attention(q, k, v, 0, lk_img, scale=inv, route="window"),
                20))
            bound_ms, bound_by = bound(io_bytes, flop / 2, "int8", [(flop / 2, "bf16")])
        else:
            alone = lambda: hk._launch_sm90(q, k, v, inv, maxima,  # noqa: E731
                                            hk._MODE_WINDOW, 0, lk_img, 1, lk_img, -1)
            extra = dict(ms=cuda_ms(alone, 20), route_ms=route_ms,
                         logit_bound=float(hk.logit_bound_from_maxima(maxima)[0]))
            faults["stale_ring_stage"] = lambda: hk._launch_sm90(
                q, k, v, inv, maxima, hk._MODE_WINDOW, 0, lk_img, 1, lk_img, -1,
                fault=hk.FAULT_STALE_RING_STAGE)
            bound_ms, bound_by = bound(io_bytes, flop, "bf16")
        image_cross[name] = dict(**res, **tol, rel_fro_by_rows=per_range, **extra,
                                 plain_ms_rows_1024=plain_ms, library_ms=library_ms,
                                 library="torch SDPA flash (bf16), unmasked"
                                 + (": no PyTorch call computes int8 QK^T attention"
                                    if int8 else ""),
                                 bound_ms=bound_ms, bound_by=bound_by)
        phase("kernel", kernel="attention", case=name, route=route, lq=tl, lk=lk_img, lo=0,
              hi=lk_img, heads=nh, head_dim=hd, checked_rows=row_ranges,
              last_k_tile_live_rows=lk_img - 128 * (lk_img // 128), **image_cross[name],
              card=card)
        if not res["within_tol"]:
            fail(f"{name}: kernel outside the bounds {tol} of the plain version: {res}")
        if int8 and not image_cross[name]["quanta_within_tol"]:
            fail(f"{name}: the pre-pass's quanta differ from the plain version's")
        if not int8 and image_cross[name]["logit_bound"] >= hk.STATIC_MAX_LIMIT:
            fail(f"{name}: the image cross case does not take the static-max path")
        for fault, fn in faults.items():
            bad = hk.agreement(torch.cat([fn()[:, a:b] for a, b in row_ranges], dim=1),
                               torch.cat(want, dim=1))
            phase("planted_fault", case=name, fault=fault, caught=not bad["within_tol"],
                  max_abs_err=bad["max_abs_err"], rel_fro_err=bad["rel_fro_err"])
            if bad["within_tol"]:
                fail(f"{name}: the check passes the planted fault {fault}: {bad}")
        del got, want
    del q, k, v, qt, kt, vt, maxima
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

    # -- the DiT's norm sites (csrc/dit_norm_sm90.cu) --
    dit_norm_phase(card, dev)

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
    int8_config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                     timestep_shift=5.0, **INT8_FLAGS)
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

    # the attention backward at the training shapes, then the training path
    bwd_results = backward_kernel_phase(card, dev, earlier_bwd)
    training = training_phase(card, dev, read_counts, kernel_mods)
    gan = gan_phases(card, dev, read_counts, kernel_mods)
    ode = ode_pairs_phase(card, dev, read_counts, kernel_mods)
    # teacher forcing: mode 2 of the two attention kernels, then the DiT
    tf_kernel = teacher_forcing_kernel_phase(card, dev)
    tf_dit = teacher_forcing_dit_phase(card, dev, read_counts, kernel_mods)

    # CLIP ViT-H/14 at full width and depth (32 blocks, dim 1280, 16 heads;
    # i2v uses 31), random f32 weights from a seed: one 832x480 image on the
    # card against the CPU's plain run (f32 both, no TF32); forward ms by
    # CUDA events over the encoder's call (resize, normalisation, 31 blocks)
    clip_gen = torch.Generator().manual_seed(5)
    vit_cpu = clip_mod.init_vit_params(clip_gen, None, "cpu")
    image = torch.rand((3, 480, 832), generator=clip_gen) * 2.0 - 1.0
    feats = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        enc = clip_mod.CLIPVisionEncoder(params=tree_to(vit_cpu, device))
        image = image.to(device)
        feats[name] = enc(image[None, :, None]).float().cpu()
    clip_ms = cuda_ms(lambda: enc(image[None, :, None]), 5)
    rel = (torch.linalg.norm(feats["gpu"] - feats["cpu"])
           / torch.linalg.norm(feats["cpu"])).item()
    phase("clip_vit_h_card_vs_cpu", blocks=31, dim=1280, heads=16, image="832x480 -> 224x224",
          features=list(feats["gpu"].shape), rel_fro_err=rel, tol=1e-3, forward_ms=clip_ms,
          finite=bool(torch.isfinite(feats["gpu"]).all()), card=card)
    if not (rel < 1e-3 and tuple(feats["gpu"].shape) == (1, 257, 1280)
            and torch.isfinite(feats["gpu"]).all()):
        fail(f"CLIP ViT-H on the card disagrees with the CPU: {rel}, "
             f"{tuple(feats['gpu'].shape)}")
    clip_fea = feats["cpu"]
    del vit_cpu, enc, feats
    gc.collect()
    torch.cuda.empty_cache()

    # the i2v DiT at i2v-14B's full width (dim 5120, 40 heads, in_dim 36) with
    # 2 layers, the image branch on (CLIP features [1, 257, 1280]), train
    # mode over 3 latent frames of 30x32 (720 tokens: the last q tile
    # ragged), a random head: the card's bf16 against the CPU's f32, as
    # dit_small_vs_cpu; three K1 launches a layer (self, text, image)
    i2v_two = dataclasses.replace(WAN_CONFIGS["i2v-14B"], num_layers=2)
    p_cpu = wan_dit.fuse_qkv_params(wan_dit.init_wan_params(i2v_two, cpu_gen, "cpu",
                                                            torch.float32))
    p_cpu["head"]["head"]["w"] = torch.randn(p_cpu["head"]["head"]["w"].shape,
                                             generator=cpu_gen) * 0.05
    p_gpu = to_gpu(p_cpu)
    ctx = torch.randn((1, 512, i2v_two.text_dim), generator=cpu_gen)
    lat = torch.randn((1, 3, 36, 30, 32), generator=cpu_gen)
    t = torch.tensor([[937.0, 937.0, 937.0]])
    outs = {}
    for name, params, device, dtype in (("cpu", p_cpu, "cpu", torch.float32),
                                        ("gpu", p_gpu, dev, torch.bfloat16)):
        for m in kernel_mods:
            m.reset_launch_counts()
        rope = RopeTables.create(i2v_two.head_dim, device=device)
        cross = wan_dit.compute_crossattn_cache(i2v_two, params, ctx.to(device, dtype),
                                                clip_fea=clip_fea.to(device, dtype))
        flow, _ = wan_dit.dit_forward(i2v_two, params, lat.to(device, dtype), t.to(device),
                                      rope, cross, "train")
        outs[name] = flow.float().cpu()
    launches_i2v, plain_i2v = read_counts()
    rel = ((outs["gpu"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()
    phase("i2v_small_card_vs_cpu", layers=2, dim=i2v_two.dim, heads=i2v_two.num_heads,
          in_dim=i2v_two.in_dim, tokens=3 * 15 * 16, image_tokens=257, rel_max_err=rel,
          tol=5e-2, launches=launches_i2v, plain_on_cuda=plain_i2v,
          shape=list(outs["gpu"].shape), card=card)
    if not (rel < 5e-2 and torch.isfinite(outs["gpu"]).all()
            and tuple(outs["gpu"].shape) == (1, 3, 16, 30, 32)):
        fail(f"the i2v forward on the card disagrees with the CPU: {rel}")
    if launches_i2v.get("window") != 3 * i2v_two.num_layers or any(plain_i2v.values()):
        fail(f"the i2v forward: K1 launches {launches_i2v}, plain on CUDA {plain_i2v}")
    del p_cpu, p_gpu, outs, cross, clip_fea
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

    tiers, skew_launches, head_w, teacher, vae_res = {}, {}, None, None, None
    megafuse_res = {}
    for tier, flags in (("bf16", {}), ("int8", INT8_FLAGS)):
        config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                    timestep_shift=5.0, **flags)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models = load(config)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        head_w = random_head(models) if head_w is None else head_w
        launches, plain_on_cuda, peak_gb, stats = serve(
            config, models, t2v_specs((f"{tier}-0", f"{tier}-1")), tier, KERNEL_PATHS[tier])
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
            megafuse_res[tier] = session_megafuse_phase(card, dev, tier, config, models, head_w,
                                                        kernel_mods, read_counts,
                                                        KERNEL_PATHS[tier])
            teacher = teacher_phases(models, head_w)
        else:
            megafuse_res[tier] = session_megafuse_phase(card, dev, tier, config, models, head_w,
                                                        kernel_mods, read_counts,
                                                        KERNEL_PATHS[tier])
            vae_res = vae_phases(card, dev, config, models, request, head_w, kernel_mods)
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
        "int8 + umT5", KERNEL_PATHS["int8"])
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
    missing = [k for k in KERNEL_PATHS["int8"] if cam_launches.get(k, 0) <= 0]
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
        int8_config, models, specs, "int8 + umT5, video in", KERNEL_PATHS["int8"], blocks=2)
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
                                         timestep_shift=5.0, checkpoint_path=ckpt, **INT8_FLAGS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models = load(ckpt_config)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    launches_ck, plain_ck, peak_ck, _ = serve(ckpt_config, models, t2v_specs(("ckpt-0",)),
                                              "int8 from checkpoint_path", KERNEL_PATHS["int8"])
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
                                      timestep_shift=5.0, use_taehv=True, **INT8_FLAGS)
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
            KERNEL_PATHS["int8"], first=9)
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
        **INT8_FLAGS)
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
    missing_sv = [k for k in KERNEL_PATHS["int8"] if launches_sv.get(k, 0) <= 0]
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
                                timestep_shift=5.0, **INT8_FLAGS)
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
                                            timestep_shift=5.0, use_taehv=True, **INT8_FLAGS)
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

    # -- i2v-14B: WanI2V.generate at full depth and width in the int8 tier,
    # 81 frames of 832x480 (21 latents, 32760 tokens) from a seeded image,
    # CLIP ViT-H random f32 on the card, seeded prompts, a random head; 2
    # UniPC steps at guidance 5 (the 50-step loop is the same code), with
    # the int8 QK^T attention (K2-int8), then with K1 in bf16. Every window
    # launch is one of the 3 attentions (self, text, image) of a layer in a
    # forward: exactly 2 x 3 x 40 x steps.
    def i2v_14b():
        i2v_steps = 2
        config = load_server_config(model_name="i2v-14B", timestep_shift=5.0, **INT8_FLAGS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = load_transformer(config, dev, seed=0)
        vae = load_vae(config, dev, seed=1)
        clip_enc = clip_mod.CLIPVisionEncoder(device=dev, seed=2)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() / 2**30
        if gen.cfg.model_type != "i2v" or gen.cfg.in_dim != 36:
            fail(f"i2v_14b: load_transformer built {gen.cfg}")
        head = gen.params["head"]["head"]
        head["w"] = (torch.randn(head["w"].shape, generator=head_gen, device=dev)
                     * 0.05).to(head["w"].dtype)
        enc = SeededTextEncoder(dev, gen.cfg.text_len, gen.cfg.text_dim)
        img = torch.rand((3, 480, 832), generator=torch.Generator(device=dev).manual_seed(9),
                         device=dev) * 2.0 - 1.0
        i2v = WanI2V(gen, enc, vae, clip_enc, sampling_steps=i2v_steps, guidance_scale=5.0)
        out, lats = {}, {}
        try:
            for route, int8qk in (("window_int8qk", True), ("window", False)):
                hk.INT8_QK = int8qk
                gc.collect()
                torch.cuda.empty_cache()
                for m in kernel_mods:
                    m.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                events, restore = timed_forwards(gen, ("cond", "uncond"))
                flows, forward = [], gen.forward

                def keep_first(*a, **k):  # the first step's conditional forward
                    res = forward(*a, **k)
                    if not flows:
                        flows.append(res[0])
                    return res

                gen.forward = keep_first
                t0 = time.perf_counter()
                try:
                    video, lat = i2v.generate(teacher_prompt, img, frame_num=81, seed=8,
                                              return_latents=True, profile=True)
                finally:
                    restore()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                launches, plain_on_cuda = read_counts()
                finite = bool(torch.isfinite(video).all() and torch.isfinite(lat).all())
                want = 2 * 3 * gen.cfg.num_layers * i2v_steps
                out[route] = dict(wall_s=wall_s, forward_ms=forward_ms(events),
                                  **i2v.last_profile, launches=launches,
                                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
                phase("i2v_14b", model="i2v-14B", tier="int8", attention_route=route,
                      steps=i2v_steps, guidance=5.0, frames=list(video.shape),
                      latents=list(lat.shape), tokens=lat.shape[1] * 1560, image_tokens=257,
                      load_and_calibrate_s=load_s, load_peak_mem_gib=load_peak,
                      **out[route], window_launches_expected=want,
                      plain_on_cuda=plain_on_cuda, finite=finite, card=card)
                if (not finite or tuple(video.shape) != (81, 3, 480, 832)
                        or launches[route] != want or any(plain_on_cuda.values())):
                    fail(f"i2v_14b ({route}): frames {tuple(video.shape)}, finite {finite}, "
                         f"launches {launches}, expected {want} on {route}, plain on CUDA "
                         f"{plain_on_cuda}")
                lats[route] = (lat, flows[0])
                del video, flows
        finally:
            hk.INT8_QK = False
        (lat8, flow8), (lat16, flow16) = lats["window_int8qk"], lats["window"]
        cos = dict(latents_cosine=cosine(lat8, lat16), cond_flow_cosine=cosine(flow8, flow16))
        phase("i2v_14b_int8qk_vs_bf16_attention", **cos, bar=0.99, card=card)
        if not (cos["latents_cosine"] > 0.99 and cos["cond_flow_cosine"] > 0.99):
            fail(f"i2v_14b: the int8 QK^T run does not track the bf16 attention's: {cos}")
        del gen, vae, clip_enc, i2v, lats
        gc.collect()
        torch.cuda.empty_cache()
        return out

    i2v14 = i2v_14b()
    server_warmup_phase(card, request)
    real_checkpoint_phase(card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_phases(card)

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

    def vae_forms(rows, temporal):
        """The conv forms held at the VAE's shard (or fused) shapes, compact:
        [x, w, stride, padding, ms, bound_ms, launches (, the unfused conv's
        ms)]."""
        return [[r["x"], r["w"], r["stride"], r["padding"], r["ms"], r["bound_ms"],
                 r["launches"]] + ([r["unfused"]["ms"]] if "unfused" in r else [])
                for r in rows if (r["w"][0] > 1) == temporal]

    split_l = vae_res["launches"]
    fused_l = vae_res["fuseup"]["int8"]["launches"]

    def times(results, case, keys=("ms", "earlier_ms")):
        """{case_key: value} of a case's times, for the kernels line."""
        return {f"{case}_{k}": results[case].get(k) for k in keys}

    kernels = [
        entry("window_attention (K1 static-max; in-kernel running-max fallback)", sm90_src,
              "realtime_video_tpu/ops/pallas_attention.py:220", bf16_l["window"],
              results["self_attn"], max(results["self_attn"]["max_abs_err"],
                                        results["cross_attn"]["max_abs_err"],
                                        image_cross["image_cross_257_14b"]["max_abs_err"]),
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
               **{f"image_cross_257_14b_{k}": image_cross["image_cross_257_14b"][k]
                  for k in ("ms", "route_ms", "plain_ms_rows_1024", "library_ms", "bound_ms",
                            "bound_by", "max_abs_err", "rel_fro_err")},
               "launches_i2v_14b_bf16_2_steps": i2v14["window"]["launches"]["window"],
               **{f"launches_gan_{r['update']}_update_{r['step']}": r["launches"]["window"]
                  for r in gan["steps"]},
               "launches_ode_pairs_teacher_2x4_steps": ode["launches"]["window"],
               **{f"gan_register_attention_{k}": gan["register_attention"][k]
                  for k in ("torch_ops_fwd_ms", "k1_route_fwd_ms", "torch_ops_fwd_bwd_ms",
                            "k1_route_fwd_bwd_ms", "bound_ms")},
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
                  + [teacher_k1["teacher_self_32760_14b_int8qk"]["max_abs_err"],
                     image_cross["image_cross_257_14b_int8qk"]["max_abs_err"]]),
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
               **{f"image_cross_257_14b_{k}": image_cross["image_cross_257_14b_int8qk"][k]
                  for k in ("ms", "bf16_route_ms", "plain_ms_rows_1024", "library_ms",
                            "bound_ms", "bound_by", "max_abs_err", "rel_fro_err",
                            "segment_rows")},
               "launches_i2v_14b_2_steps":
               i2v14["window_int8qk"]["launches"]["window_int8qk"],
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
               "launches_14b": launches14["int8_linear_k_tiled"],
               "launches_i2v_14b_2_steps":
               i2v14["window_int8qk"]["launches"]["int8_linear_k_tiled"]}),
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
               "launches_i2v_14b_encode_and_decode":
               i2v14["window"]["launches"]["conv3x3"]
               - i2v14["window"]["launches"]["conv3x3_temporal"],
               "launches_webcam_encode_block0": encode_launches["block0"]["kt1"],
               "launches_webcam_encode_warm_block": encode_launches["warm"]["kt1"],
               "webcam_encoder_forms_held_here": encoder_forms_checked["kt1"],
               **{f"launches_vae_split_{sp}_decode_and_encode":
                  split_l[sp]["conv3x3"] - split_l[sp]["conv3x3_temporal"]
                  for sp in ("sp2", "sp4")},
               "vae_shard_forms": vae_forms(vae_res["shard_forms"], False),
               "launches_vae_fuseup_int8_decode":
               fused_l["conv3x3"] - fused_l["conv3x3_temporal"],
               "vae_fuseup_forms_co4x": vae_forms(vae_res["fuseup"]["int8"]["fused_forms"],
                                                  False)}),
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
               "launches_i2v_14b_encode_and_decode":
               i2v14["window"]["launches"]["conv3x3_temporal"],
               "launches_webcam_encode_block0": encode_launches["block0"]["kt3"],
               "launches_webcam_encode_warm_block": encode_launches["warm"]["kt3"],
               "webcam_encoder_forms_held_here": encoder_forms_checked["kt3"],
               **{f"launches_vae_split_{sp}_decode_and_encode": split_l[sp]["conv3x3_temporal"]
                  for sp in ("sp2", "sp4")},
               "vae_shard_forms": vae_forms(vae_res["shard_forms"], True),
               "launches_vae_fuseup_int8_decode": fused_l["conv3x3_temporal"]}),
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
        entry("attention_backward (dq, dk, dv of K1/K2's function: D pre-pass, dQ pass, "
              "dK/dV pass; wgmma, TMA, warp-specialised)",
              "realtime_video_tpu_torch/csrc/attention_bwd_sm90.cu",
              "realtime_video_tpu/ops/attention.py:72",
              sum(training[key][b] for key in ("launches_dmd", "launches_flow_matching")
                  for b in ("window_bwd", "block_causal_bwd"))
              + sum(r["launches"]["window_bwd"] for r in gan["steps"])
              + sum(ode["update_launches"][b] for b in ("window_bwd", "block_causal_bwd")),
              bwd_results["decode_4680x9360"],
              max(r["max_abs_err"] for r in bwd_results.values()),
              {"case": "decode window 4680 x 9360, 12 heads (ms: the D pre-pass, dQ and dK/dV "
                       "passes); replaces no Pallas kernel: the JAX trainer differentiates "
                       "xla_attention",
               "library": bwd_results["decode_4680x9360"]["library"],
               "earlier_ms": bwd_results["decode_4680x9360"]["earlier_ms"],
               "deterministic": all(r["deterministic"] for r in bwd_results.values()),
               "ptxas": bwd_ptxas, "sass": sass[libs[hk.BWD_SOURCE].name],
               **{f"{c}_{k}": bwd_results[c][k] for c, *_ in BWD_CASES
                  for k in ("ms", "earlier_ms", "dq_pass_ms", "plain_ms", "library_ms",
                            "bound_ms", "max_abs_err", "rel_fro_err")},
               **{f"{c}_library_errors": bwd_results[c]["library_errors"]
                  for c, *rest in BWD_CASES if rest[-1]},
               "launches_dmd_2_steps": training["launches_dmd"]["window_bwd"],
               "launches_flow_matching_step": training["launches_flow_matching"],
               **{f"launches_gan_{r['update']}_update_{r['step']}": r["launches"]["window_bwd"]
                  for r in gan["steps"]},
               "launches_ode_regression_update": {
                   b: ode["update_launches"][b] for b in ("window_bwd", "block_causal_bwd")}}),
        entry("teacher_forcing_attention (mode 2 of the same two kernels: a query tile walks "
              "two key ranges, [clean | noisy]; forward and backward)", sm90_src,
              "none: realtime_video_tpu/ops/attention.py:147 teacher_forcing_mask (dense XLA, "
              "no Pallas kernel)", tf_dit["launches_forward_backward"]["teacher_forcing"],
              tf_kernel, max(tf_kernel["max_abs_err"], tf_kernel["bwd_max_abs_err"]),
              {"case": "2L = 18720 in blocks of 4680, 12 heads (train.py's shape); ms the "
                       "forward route (one launch); launches those of one DiT forward + "
                       "backward at t2v-1.3B (checkpointing reruns each layer's forward)",
               "source_backward": "realtime_video_tpu_torch/csrc/attention_bwd_sm90.cu",
               "library": tf_kernel["library"],
               "launches_backward": tf_dit["launches_forward_backward"]["teacher_forcing_bwd"],
               "launches_forward_only": tf_dit["launches_forward"]["teacher_forcing"],
               **{k: tf_kernel[k] for k in ("forward_with_lse_ms", "bwd_ms", "bwd_plain_ms",
                                            "bwd_library_ms", "bwd_bound_ms", "bwd_bound_by",
                                            "bwd_max_abs_err", "rel_fro_err", "bwd_rel_fro_err",
                                            "lse_max_abs_err", "live_pairs_per_head")},
               "deterministic": tf_kernel["deterministic"]}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def _phases_alone(what: str):
    """The start of a run of some phases alone, as `main` starts: the card
    (printed), the kernels built, TF32 off, the static text embedding, no
    quantised-tree cache. Returns (card, device, kernel modules,
    read_counts: (launches, plain-on-CUDA counts))."""
    import torch

    from realtime_video_tpu_torch.ops import cuda_build
    from realtime_video_tpu_torch.ops import hopper_attention as hk
    from realtime_video_tpu_torch.ops import hopper_conv as hc
    from realtime_video_tpu_torch.ops import hopper_dit_norm as hdn
    from realtime_video_tpu_torch.ops import hopper_int8_mm as hm

    if not torch.cuda.is_available():
        fail(f"no CUDA device: the {what} need an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all([*hk.SOURCES, hm.SOURCE, hc.SOURCE, hdn.SOURCE])
    phase("device", card=card, kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), kernel_build_s=time.perf_counter() - t0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["USE_STATIC_ENCODER_COND_DICT"] = "1"
    os.environ["RTV_QUANT_CACHE"] = "0"
    kernel_mods = (hk, hm, hc, hdn)

    def read_counts():
        """(launches, plain-on-CUDA counts). The DiT norm kernels have no
        backward, so training takes their plain chains on a card by design:
        their PLAIN_ON_CUDA is left out here and held at 0 where a session
        serves (`session_megafuse_phase`)."""
        launches = {k: v for m in kernel_mods for k, v in m.LAUNCHES.items()}
        launches.update(hk.PREPASS_LAUNCHES)
        launches.update(hc.PREPASS_LAUNCHES)
        return launches, {k: v for m in kernel_mods if m is not hdn
                          for k, v in m.PLAIN_ON_CUDA.items()}

    return card, torch.device("cuda", 0), kernel_mods, read_counts


def _head_w(models, dev):
    """The random head the phases run alone put on the DiT (seed 11)."""
    import torch

    shape = models.transformer.params["head"]["head"]["w"].shape
    return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(11),
                       device=dev) * 0.05


def _ok_line() -> None:
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def vae_main(phases) -> None:
    """`python3 chip_smoke.py --vae-phases [split] [fuseup] [multi_gpu]`: the
    VAE phases alone (`vae_phases`; all three without names), on the 1.3B
    int8 tier's models with the static embedding, as `main` runs them: the
    way to run `vae_multi_gpu` on a machine with several cards."""
    from realtime_video_tpu_torch.config import load_server_config
    from realtime_video_tpu_torch.serving.models import load_all

    unknown = set(phases) - {"split", "fuseup", "multi_gpu"}
    if unknown:
        fail(f"unknown VAE phases {sorted(unknown)}: split, fuseup, multi_gpu")
    card, dev, kernel_mods, _ = _phases_alone("VAE phases")
    config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                timestep_shift=5.0, **INT8_FLAGS)
    models = load_all(config, dev, seed=0)
    request = {"prompt": "a red fox running through snow", "width": 832, "height": 480,
               "seed": 7, "num_blocks": 3, "num_denoising_steps": 4, "kv_cache_num_frames": 3}
    vae_phases(card, dev, config, models, request, _head_w(models, dev), kernel_mods,
               tuple(phases) or ("split", "fuseup", "multi_gpu"))
    _ok_line()


def megafuse_main() -> None:
    """`python3 chip_smoke.py --session-phases`: `session_megafuse_phase` alone
    on the 1.3B bf16 tier, then the int8 tier, each loaded as `main` loads
    it (the static embedding)."""
    import torch

    from realtime_video_tpu_torch.config import load_server_config
    from realtime_video_tpu_torch.serving.models import load_all

    card, dev, kernel_mods, read_counts = _phases_alone("session phases")
    head_w = None
    for tier, flags in (("bf16", {}), ("int8", INT8_FLAGS)):
        config = load_server_config(model_name="t2v-1.3B", num_frame_per_block=3,
                                    timestep_shift=5.0, **flags)
        models = load_all(config, dev, seed=0)
        head_w = _head_w(models, dev) if head_w is None else head_w
        session_megafuse_phase(card, dev, tier, config, models, head_w, kernel_mods,
                               read_counts, KERNEL_PATHS[tier])
        del models
        gc.collect()
        torch.cuda.empty_cache()
    _ok_line()


def dit_norm_main() -> None:
    """`python3 chip_smoke.py --dit-norm-phases`: phase 2's DiT norm entries
    alone (`dit_norm_phase`)."""
    card, dev, _, _ = _phases_alone("DiT norm phases")
    dit_norm_phase(card, dev)
    _ok_line()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--vae-phases"]:
        vae_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--dit-norm-phases"]:
        dit_norm_main()
    elif sys.argv[1:2] == ["--session-phases"]:
        megafuse_main()
    else:
        main()
