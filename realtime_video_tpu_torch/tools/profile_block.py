"""Profile one warm block of the serving path, or one step of the 50-step
teacher, on a GPU.

    python -m realtime_video_tpu_torch.tools.profile_block [--model t2v-1.3B|t2v-14B]
        [--tier bf16|int8] [--int8-qk] [--webcam] [--umt5] [--taehv] [--out profile_out]
    python -m realtime_video_tpu_torch.tools.profile_block --teacher
        [--model t2v-1.3B|t2v-14B] [--clip-steps N] [--out profile_out]

`load_all` builds the DiT (default t2v-1.3B; random weights from a seed) and
the Wan 2.1 VAE on the card, in bf16 or in the int8 tier (the server flags
`enable_int8`, `enable_int8_dit` and `int8_static_scales`: calibrated and
quantised on the card), with the int8 QK^T attention when `--int8-qk` is
given (RTV_ATTN_INT8's switch, set before the load), and one session runs at
832x480, 4 denoising steps and
3 KV-cache frames, as the server drives it (each block's frames are copied to
the host). Blocks 0-2 warm up (block 2 is the first with the anti-drift
re-encode). Then:

  * block 3 runs unprofiled: its host wall time, with a device sync at both
    ends, and the device time of each phase (anti-drift VAE re-encode, KV
    prefill, 4-step denoise, VAE decode) from the port's spans
    (`utils/trace.py`, recorded with CUDA events: `phase_device_ms`). The session runs
    its default throughput mode (RTV_SESSION_MEGAFUSE=1: a warm block's
    frames sent by one callback); with RTV_SESSION_MEGAFUSE=0 in the
    environment it sends each latent's frames, and the reports' names end
    in `_streamed`. Either way each latent's decode is its own
    `decode_block` call, timed as `vae_decode`;
  * block 4 runs under torch.profiler inside the range `warm_block`, which
    ends with a device sync: device time by kernel and by category, and the
    device's busy time against that range's own span. The span carries the
    profiler's host overhead, so its idle share is an upper bound. In the
    int8 tier the same block records the shape of every launch of the conv
    kernel (K4/K5) and of its quantise pre-pass, and sums their bounds: the
    larger of the bytes a launch must move over 3.35 TB/s and its s8
    operations over 1979 TOP/s (the H100 SXM data sheet at 700 W, as
    chip_smoke.py counts them).

With `--webcam` the session runs in webcam mode (strength 0.7): before each
block the frames it takes (9 at block 0, then 12) are pushed as seeded
640x480 JPEGs and decoded on the calling thread, and the stream encode of
those frames (resize to 832x480, the VAE encoder through its cache) is its
own phase, `webcam_encode`. The text encoder is the static embedding
(USE_STATIC_ENCODER_COND_DICT) unless `--umt5` asks for load_all's default,
umT5-xxl; then one forward of it at its 512 tokens is also timed with CUDA
events and profiled the same way (`umt5`).

With `--taehv` the server config asks for the TAEHV preview tier
(`use_taehv`): each block is decoded whole by TAEHV (random weights without
RTV_TAEHV_CKPT's file), timed as the phase `taehv_decode`, its convolutions
bucketed with the other cuDNN convs (`conv`), beside the decode's bound
(`taehv_decode_bound`: its conv operations over 989 TFLOP/s bf16 or its
bytes over 3.35 TB/s, the larger).

Writes profile_block_<model>_<tier>[_int8qk][_webcam][_umt5][_taehv][_streamed].json and
the op table (.txt) under --out and prints the JSON summary. Quantised trees
are not cached on disk unless RTV_QUANT_CACHE asks for it.

With `--teacher` it profiles the bf16 teacher instead (`WanDiffusion`, random
weights from a seed and a random head, as the head's init is zero): one
classifier-free-guidance step, a conditional and an unconditional train-mode
forward over a whole 81-frame clip at 832x480 (21 latents, 32760 tokens,
each attending to all of them), the prompts' embeddings from
`SeededTextEncoder`. After a warm step, one step runs unprofiled (its host
wall with a sync at both ends, each forward's CUDA-event time), then one
under torch.profiler inside the range `cfg_step`: device time by kernel,
with the attention kernel and its bound pre-pass split into self- and
cross-attention (their launches alternate in that order in every layer),
cuBLAS and the elementwise ops apart, and the busy share of the range's
span. `--clip-steps N` then times one whole `WanT2V.generate` of N UniPC
steps with the Wan 2.1 VAE's decode (bf16), each step and the decode ended
by a sync. Writes profile_teacher_<model>.json and .txt.

With `--train` it profiles train.py's distillation step instead
(`train.build` / `train.train_step` on configs/train_dmd_t2v_1.3B.yaml:
three t2v-1.3B bf16 networks from seeds 0 / 1 / 2 with random heads, the
seeded text embedding, 6 latent frames of 60x104, steps 1000 / 750 / 500
/ 250, guidance 3, every DiT layer under checkpointing). Step 0 warms up; step 1
runs unprofiled (the generator and critic updates' host walls with a sync at
each end, the peak memory, the launch counts), then step 2 under
torch.profiler with each update (its loss, backward and optimizer step,
ended by a sync) in its own range, `generator_step` and `critic_step`:
device time by kernel and by category (the attention backward kernel
apart), and the busy share of each range's span. Writes
profile_train_<model>.json and .txt.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

BLOCKS = 5
CATEGORIES = ("attention_kernel", "attention_bound_prepass", "attention_int8_prepass",
              "attention_backward_kernel", "int8_linear_kernel",
              "conv3x3_kernel", "dit_norm_kernel", "gemm", "conv", "copy/memset",
              "elementwise/other")
#: the H100 SXM data-sheet rates the bounds use (chip_smoke.py's)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
TIER_FLAGS = {"bf16": {},
              "int8": {"enable_int8": True, "enable_int8_dit": True, "int8_static_scales": True}}


def category(kernel_name: str) -> str:
    """Bucket a device kernel by its name: the port's hand-written kernels
    (the attention kernels, the logit-bound pre-pass, the int8 QK^T
    pre-pass, the attention backward, the int8 linear with its quantise pre-pass, the conv with
    its quantise pre-pass, the DiT's norm kernels), then
    library GEMMs and convolutions, copies, and the rest."""
    n = kernel_name.lower()
    if "attn_bwd_" in n:
        return "attention_backward_kernel"  # its D pre-pass, dQ and dK/dV passes
    if "attn_logit_bound" in n:
        return "attention_bound_prepass"
    if "attention_kernel" in n:
        return "attention_kernel"
    if "attn_int8_" in n:
        return "attention_int8_prepass"
    if "int8_linear_kernel" in n:
        return "int8_linear_kernel"
    if "conv_kernel<" in n or "conv_kernel_sm90" in n or "conv_quantize_kernel" in n:
        return "conv3x3_kernel"  # the int8 VAE convs with their quantise pre-pass
    if "dit_add_ln_modulate_kernel" in n or "dit_qk_norm_rope_kernel" in n:
        return "dit_norm_kernel"  # the DiT's norm sites (csrc/dit_norm_sm90.cu)
    if n.startswith("memcpy") or n.startswith("memset"):
        return "copy/memset"
    if "fprop" in n or "conv" in n or "cudnn" in n:
        return "conv"
    if "gemm" in n or "nvjet" in n or "cutlass" in n:
        return "gemm"
    return "elementwise/other"


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by possibly overlapping [start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


class ConvBounds:
    """Records, while enabled, the shapes of the int8 VAE conv's launches
    (the conv kernel and its quantise pre-pass) and sums their bounds."""

    def __init__(self, hc):
        self.hc = hc
        self.enabled = False
        self.shapes: Dict[str, int] = defaultdict(int)
        self.conv_ms = self.quantize_ms = 0.0
        self.launches = {"conv": 0, "quantize": 0}
        launch, quantize = hc._launch, hc._quantize_launch

        def conv(x, w, stride=(1, 1), padding=((1, 1), (1, 1)), bias=None, fault=0,
                 dequant=None):
            if self.enabled:
                out_bytes = 4 if x.dtype == torch.int8 and dequant is None else 2
                moved = hc.conv3x3_bytes(x.shape, w.shape, stride, padding, in_bytes=1,
                                         out_bytes=out_bytes, bias=bias is not None)
                ops = hc.conv3x3_ops(x.shape, w.shape, stride, padding)
                self.conv_ms += max(moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
                self.launches["conv"] += 1
                self.shapes[f"x{list(x.shape)} w{list(w.shape)} s{list(stride)}"] += 1
            return launch(x, w, stride, padding, bias, fault, dequant)

        def quant(x, a_scale):
            if self.enabled:
                # bf16 in, s8 out with its channels padded
                moved = x.numel() * 2 + x.numel() // x.shape[-1] * hc.channel_pad(
                    x.shape[-1], torch.int8)
                self.quantize_ms += moved / HBM_BYTES_PER_S * 1e3
                self.launches["quantize"] += 1
            return quantize(x, a_scale)

        hc._launch, hc._quantize_launch = conv, quant

    def summary(self) -> dict:
        return {"launches": self.launches, "conv_bound_ms": self.conv_ms,
                "quantize_bound_ms": self.quantize_ms, "shapes": dict(self.shapes)}


#: the report's phase of each span
PHASES = {"dit.prefill": "prefill", "dit.step": "denoise", "vae.decode": "vae_decode",
          "vae.encode": "vae_reencode", "vae.taehv_decode": "taehv_decode",
          "session.webcam_encode": "webcam_encode"}


def phase_device_ms(records) -> Dict[str, float]:
    """Device ms of each phase the block ran, summed over its spans (records
    with device events, the device synchronised): the prefill, the
    denoise's steps, each latent's decode, the anti-drift re-encode (a
    `vae.encode` outside the webcam's encode, which is its own phase),
    TAEHV's decode and the webcam encode."""
    by_id = {r.id: r for r in records}

    def in_webcam_encode(r) -> bool:
        while r.parent in by_id:
            r = by_id[r.parent]
            if r.name == "session.webcam_encode":
                return True
        return False

    out: Dict[str, float] = defaultdict(float)
    for r in records:
        phase = PHASES.get(r.name)
        if phase and not (phase == "vae_reencode" and in_webcam_encode(r)):
            out[phase] += r.device_ms()
    return dict(out)


def device_events(prof, range_name: str):
    """(the host range's event, the device kernels and copies that start
    inside its span); the ranges' own annotations on the GPU timeline are
    left out."""
    events = prof.events()
    span = next(e for e in events if e.name == range_name)
    start, end = span.time_range.start, span.time_range.end
    return span, [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != range_name and not getattr(e, "is_user_annotation", False)
                  and start <= e.time_range.start < end]


def device_summary(prof, range_name: str) -> dict:
    """The device's busy time inside the host range `range_name` against the
    range's span, and device time by category and by kernel."""
    span, device = device_events(prof, range_name)
    span_start, span_end = span.time_range.start, span.time_range.end
    intervals = [(max(e.time_range.start, span_start), min(e.time_range.end, span_end))
                 for e in device]
    busy_ms = union_length((a, b) for a, b in intervals if b > a) / 1e3
    span_ms = (span_end - span_start) / 1e3
    by_cat: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in device:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_cat[category(e.name)] += ms
        by_kernel[e.name][0] += ms
        by_kernel[e.name][1] += 1
    top = sorted(([ms, n, name[:140]] for name, (ms, n) in by_kernel.items()), reverse=True)
    return {"profiled_span_ms": span_ms, "device_busy_ms": busy_ms,
            "idle_share_of_profiled_span": 1.0 - busy_ms / span_ms,
            "device_ms_by_category": by_cat, "top_kernels": top[:25]}


def teacher_categories(events) -> Dict[str, float]:
    """Device ms by bucket for the train-mode forwards: `category`'s, with
    the attention kernel's and the bound pre-pass's launches split into
    self- and cross-attention by launch order (every layer attends over its
    tokens, then over the text, so the launches alternate, self first)."""
    out: Dict[str, float] = defaultdict(float)
    seen: Dict[str, int] = defaultdict(int)
    for e in sorted(events, key=lambda e: e.time_range.start):
        cat = category(e.name)
        if cat in ("attention_kernel", "attention_bound_prepass"):
            side = "self_" if seen[cat] % 2 == 0 else "cross_"
            seen[cat] += 1
            cat = side + cat
        out[cat] += (e.time_range.end - e.time_range.start) / 1e3
    return dict(out)


def report_stem(model: str, tier: str, int8_qk=False, webcam=False, umt5=False,
                taehv=False, streamed=False) -> str:
    """The reports' file name, without its extension."""
    return (f"profile_block_{model}_{tier}" + ("_int8qk" if int8_qk else "")
            + ("_webcam" if webcam else "") + ("_umt5" if umt5 else "")
            + ("_taehv" if taehv else "") + ("_streamed" if streamed else ""))


def taehv_decode_bound(latent_frames: int, lat_h: int, lat_w: int) -> dict:
    """The bound of one bf16 TAEHV decode of a block: its conv operations over
    the bf16 peak or its bytes over HBM's rate, whichever is larger."""
    from realtime_video_tpu_torch.models import taehv

    macs, io_bytes = taehv.decode_work(latent_frames, lat_h, lat_w, itemsize=2)
    ops_ms, bytes_ms = 2 * macs / BF16_OPS_PER_S * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    return {"flop": 2 * macs, "bytes": io_bytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def webcam_jpegs(count: int = 24, seed: int = 24) -> List[bytes]:
    """Seeded 640x480 JPEG frames, each the last shifted 8 pixels."""
    import numpy as np
    from PIL import Image

    pic = np.random.default_rng(seed).random((480, 640, 3))
    out = []
    for i in range(count):
        buf = io.BytesIO()
        Image.fromarray((np.roll(pic, 8 * i, axis=1) * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def op_table(profs) -> str:
    """The profilers' op tables, by device time."""
    from torch.autograd.profiler_util import FunctionEventAvg

    sort_key = ("self_device_time_total" if hasattr(FunctionEventAvg, "self_device_time_total")
                else "self_cuda_time_total")
    return "\n\n".join(p.key_averages().table(sort_by=sort_key, row_limit=60) for p in profs)


def teacher(args, card: str) -> None:
    """The --teacher profile (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from realtime_video_tpu_torch.config import SAMPLE_NEG_PROMPT, load_server_config
    from realtime_video_tpu_torch.generators import WanT2V
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
    from realtime_video_tpu_torch.models.text_encoder import SeededTextEncoder
    from realtime_video_tpu_torch.serving.models import load_vae
    from realtime_video_tpu_torch.solvers import make_solver

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = WanDiffusion(model_name=args.model, device=dev, seed=0)
    head = gen.params["head"]["head"]
    head["w"] = (torch.randn(head["w"].shape, generator=torch.Generator(device=dev).manual_seed(11),
                             device=dev) * 0.05).to(head["w"].dtype)
    enc = SeededTextEncoder(dev, gen.cfg.text_len, gen.cfg.text_dim)
    prompt = "a red fox running through snow"
    cross_c = gen.compute_crossattn_cache(enc([prompt])["prompt_embeds"])
    cross_u = gen.compute_crossattn_cache(enc([SAMPLE_NEG_PROMPT])["prompt_embeds"])
    shape = WanT2V.latent_shape((832, 480), 81)
    latent = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(21),
                         device=dev).to(gen.dtype)
    solver = make_solver("unipc", 50, 5.0)
    t = torch.full(shape[:2], float(solver.timesteps[0]), dtype=torch.float32, device=dev)
    fwd_events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def forward(cross):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        flow, _, _ = gen.forward(latent, cross, t, mode="train")
        end.record()
        fwd_events.append((start, end))
        return flow

    def cfg_step():
        flow_c = forward(cross_c)
        flow_u = forward(cross_u)
        return flow_u + 5.0 * (flow_c - flow_u)

    cfg_step()
    torch.cuda.synchronize()
    fwd_events.clear()
    t0 = time.perf_counter()
    flow = cfg_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    fwd_ms = [a.elapsed_time(b) for a, b in fwd_events]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("cfg_step"):
            cfg_step()
            torch.cuda.synchronize()
    step = device_summary(prof, "cfg_step")
    step["device_ms_by_category"] = teacher_categories(device_events(prof, "cfg_step")[1])
    summary = {"card": card, "model": args.model, "tier": "bf16", "latents": list(shape),
               "tokens": shape[1] * gen.cfg.frame_seq_length(*shape[-2:]),
               "step_wall_ms": wall_ms, "forward_ms": {"cond": fwd_ms[0], "uncond": fwd_ms[1]},
               "flow_finite": bool(torch.isfinite(flow).all()), **step,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if args.clip_steps:
        vae = load_vae(load_server_config(), dev, seed=1)
        wan = WanT2V(gen, enc, vae, sampling_steps=args.clip_steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = wan.generate(prompt, seed=7, profile=True)
        torch.cuda.synchronize()
        prof_clip = wan.pipeline.last_profile
        summary["clip"] = {"steps": args.clip_steps, "forwards": 2 * args.clip_steps,
                           "wall_s": time.perf_counter() - t0,
                           "step_ms": prof_clip["step_ms"], "decode_ms": prof_clip["decode_ms"],
                           "frames": list(video.shape),
                           "finite": bool(torch.isfinite(video).all()),
                           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = f"profile_teacher_{args.model}"
    (out / f"{stem}.json").write_text(json.dumps(summary, indent=1))
    (out / f"{stem}.txt").write_text(op_table([prof]))
    print(json.dumps({k: v for k, v in summary.items() if k != "top_kernels"}), flush=True)


def train(args, card: str) -> None:
    """The --train profile (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from realtime_video_tpu_torch import train as train_mod
    from realtime_video_tpu_torch.ops import hopper_attention as hk

    tr = train_mod.build(train_mod.parse_args([
        "--config", train_mod.TRAIN_CONFIG, "--text-encoder", "seeded",
        "--lr", "1e-4", "--critic-lr", "1e-4"]))
    model = tr.config.model_name
    train_mod.train_step(tr, 0)
    hk.reset_launch_counts()
    unprofiled = train_mod.train_step(tr, 1)
    launches = dict(hk.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = train_mod.train_step(tr, 2, span=record_function)
    summary = {"card": card, "model": model, "tier": "bf16", "latents": [6, 60, 104],
               "unprofiled_step": unprofiled, "profiled_step": profiled,
               "launches_per_step": launches,
               **{name: device_summary(prof, name) for name in train_mod.SPANS}}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = f"profile_train_{model}"
    (out / f"{stem}.json").write_text(json.dumps(summary, indent=1))
    (out / f"{stem}.txt").write_text(op_table([prof]))
    print(json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "top_kernels"}
                          if k in train_mod.SPANS else v) for k, v in summary.items()}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("t2v-1.3B", "t2v-14B"), default="t2v-1.3B",
                    help="the DiT to serve")
    ap.add_argument("--tier", choices=sorted(TIER_FLAGS), default="bf16",
                    help="the serving tier to profile")
    ap.add_argument("--int8-qk", action="store_true",
                    help="the int8 QK^T attention (RTV_ATTN_INT8's switch)")
    ap.add_argument("--webcam", action="store_true",
                    help="a webcam session: frames pushed before each block, their stream "
                         "encode timed as its own phase")
    ap.add_argument("--umt5", action="store_true",
                    help="load_all's default text encoder, umT5-xxl (else the static "
                         "embedding), and a profile of one forward of it")
    ap.add_argument("--taehv", action="store_true",
                    help="the TAEHV preview tier (use_taehv): each block decoded whole by "
                         "TAEHV, timed as its phase")
    ap.add_argument("--teacher", action="store_true",
                    help="profile one CFG step of the bf16 teacher over an 81-frame clip "
                         "instead of a serving block")
    ap.add_argument("--train", action="store_true",
                    help="profile one step of train.py's DMD distillation at full width "
                         "instead of a serving block")
    ap.add_argument("--clip-steps", type=int, default=0,
                    help="with --teacher: then time one WanT2V.generate of this many steps")
    ap.add_argument("--out", default="profile_out", help="directory for the reports")
    args = ap.parse_args()
    os.environ.setdefault("RTV_QUANT_CACHE", "0")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.teacher:
        return teacher(args, card)
    if args.train:
        return train(args, card)
    if args.umt5:
        os.environ.pop("USE_STATIC_ENCODER_COND_DICT", None)
    else:
        os.environ["USE_STATIC_ENCODER_COND_DICT"] = "1"

    from torch.profiler import ProfilerActivity, profile, record_function

    from realtime_video_tpu_torch.config import load_server_config
    from realtime_video_tpu_torch.models import t5 as t5_mod
    from realtime_video_tpu_torch.ops import hopper_attention, hopper_conv
    from realtime_video_tpu_torch.serving import session as session_mod
    from realtime_video_tpu_torch.serving.models import load_all
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession
    from realtime_video_tpu_torch.utils import trace

    dev = torch.device("cuda")
    config = load_server_config(model_name=args.model, num_frame_per_block=3,
                                timestep_shift=5.0, use_taehv=args.taehv,
                                **TIER_FLAGS[args.tier])
    hopper_attention.INT8_QK = args.int8_qk
    torch.cuda.reset_peak_memory_stats()
    models = load_all(config, dev, seed=0)
    load_peak_gib = torch.cuda.max_memory_allocated() / 2**30

    conv_bounds = ConvBounds(hopper_conv)

    params = GenerateParams(prompt="a red fox running through snow", width=832, height=480,
                            seed=7, num_blocks=BLOCKS, num_denoising_steps=4,
                            kv_cache_num_frames=3, webcam_mode=args.webcam,
                            strength=0.7 if args.webcam else 1.0)
    session = GenerationSession(params, config, models=models,
                                frame_callback=lambda px, ids, ev: px.float().cpu())
    jpegs, pushed = webcam_jpegs(), [0]

    def run_block(prof_range=None):
        """One block; in webcam mode the frames it takes are pushed first."""
        if args.webcam:
            for _ in range(9 if session.block_idx == 0 else 12):
                session.push_frame(jpegs[pushed[0] % len(jpegs)])
                pushed[0] += 1
        if prof_range is None:
            return session.generate_block(models)
        with record_function(prof_range):
            session.generate_block(models)
            torch.cuda.synchronize()

    for _ in range(BLOCKS - 2):
        run_block()
    torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    trace.start(device_events=True)
    t0 = time.perf_counter()
    run_block()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    phases = phase_device_ms(trace.stop())

    conv_bounds.enabled = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_block("warm_block")
    conv_bounds.enabled = False
    block = device_summary(prof, "warm_block")

    summary = {
        "card": card, "model": args.model, "tier": args.tier, "int8_qk": args.int8_qk,
        "webcam": args.webcam, "text_encoder": "umt5-xxl" if args.umt5 else "static",
        "megafuse": session_mod.megafuse_enabled(),
        "load_peak_mem_gib": load_peak_gib,
        "warm_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "blocks": BLOCKS, "timed_block": BLOCKS - 2,
        "profiled_block": BLOCKS - 1,
        "warm_block_wall_ms": wall_ms, "phase_device_ms": phases,
        **block, "int8_vae_conv_bounds": conv_bounds.summary(),
        "taehv": args.taehv,
        "taehv_decode_bound": taehv_decode_bound(3, 60, 104) if args.taehv else None,
    }
    tables = [prof]
    if args.umt5:
        te = models.text_encoder
        ids, mask = te.tokenizer([params.prompt])
        ids, mask = torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).to(dev)

        def forward():
            return t5_mod.encode_prompts(te.cfg, te.params, ids, mask)

        forward()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            forward()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_t5:
            with record_function("umt5_forward"):
                forward()
                torch.cuda.synchronize()
        summary["umt5"] = {"forward_ms": start.elapsed_time(end) / 10, "length": ids.shape[1],
                           **device_summary(prof_t5, "umt5_forward")}
        tables.append(prof_t5)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = report_stem(args.model, args.tier, args.int8_qk, args.webcam, args.umt5, args.taehv,
                       not session_mod.megafuse_enabled())
    (out / f"{stem}.json").write_text(json.dumps(summary, indent=1))
    (out / f"{stem}.txt").write_text(op_table(tables))
    print(json.dumps({k: (v if k != "umt5" else {kk: vv for kk, vv in v.items()
                                                  if kk != "top_kernels"})
                      for k, v in summary.items() if k != "top_kernels"}), flush=True)


if __name__ == "__main__":
    main()
