"""Run one cell of the port's benchmark and print its result line.

    python -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `realtime_video_tpu_torch`. One
process a run, on the cards the cell asks for; too few cards, no result
(exit 2). The port runs on card 0, with its VAE where the traffic mix's
`placement` puts it (its own card, or split by rows over cards 1..N).

Set-up: the models through the port's own loader (`serving.models.load_all`:
the int8 tier calibrated and quantised on the card, the quantised-tree cache
off) with the benchmark's weights (`weights.py`) put in place of the
port's random init, the port's warm-up for the cell's one shape and one
3-block session. The window: sessions of the cell's traffic mix
(`traffic_gen.py`), one at a time, each a `GenerationSession` driven block
by block with `generate_block`; its frame callback hands each tensor to one
host thread that copies it to NumPy (`to_host`, as the server does) and
stamps it. Nothing is compiled in the window. After it: the metrics, the
models freed, then the check of what the window produced against the
float32 reference (`reference/`), each number beside its limit.

`--trace 1` runs the same window with CUDA-event spans around the port's
layers (wrapped here, at run time; the VAE's on the VAE's card), profiles
one session's warm blocks 1-3 with torch.profiler, each card's kernels
kept apart, and prints the per-layer metrics that
`gpubench/metrics/<name>.py` read from them.
"""
from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "gpubench"
#: fixed cache directories inside the checkout (kernel libraries build in the
#: port's own realtime_video_tpu_torch/_build/)
CACHE = ROOT / ".bench_cache"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "realtime_video_tpu")
#: the environment switches of the port that the run fixes (the rest cleared)
CLEARED_PREFIXES = ("RTV_",)
CLEARED = ("USE_STATIC_ENCODER_COND_DICT", "MODEL_FOLDER", "DO_COMPILE")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(name: str, manifest: dict):
    """(workload entry, configuration dict, traffic mix dict) of a cell."""
    from gpubench import traffic_gen

    work = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == work["config"])
    return work, load_json(ROOT / conf["file"]), traffic_gen.load(work["traffic"])


def metric_reader(name: str):
    """`read(run)` of gpubench/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def prepare_environment(cfg: dict) -> None:
    """Fix the port's switches to the configuration's and its defaults, and
    keep every cache inside the checkout. Must run before the port is
    imported (it reads some switches at import)."""
    for key in list(os.environ):
        if key.startswith(CLEARED_PREFIXES) or key in CLEARED:
            del os.environ[key]
    os.environ.update({
        "RTV_QUANT_CACHE": "0",
        "RTV_ATTN_INT8": "1" if cfg["port"]["int8_qk_attention"] else "0",
        # no model folder: random weights, the hash tokenizer
        "MODEL_FOLDER": str(CACHE / "no_model_folder"),
        "TRITON_CACHE_DIR": str(CACHE / "triton"),
        "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
        "USE_FLAX": "0", "USE_TF": "0",
    })


def pin_process() -> None:
    """Keep the run on two fixed cores (the third and fourth it may use) and
    one OpenMP thread: the 1.3B cell's host thread launches the kernels, and
    on a free choice of cores its runs read slower and spread wider. Called
    before torch is imported, so that its threads inherit both."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, cores[2:4])
    os.environ["OMP_NUM_THREADS"] = "1"


def card_line(torch) -> str:
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        limit = "nvidia-smi not readable"
    return (f"card: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
            f"nvidia-smi: {limit}")


#: the DiT's sizes that the file and the port's WanModelConfig both hold
DIT_SIZES = ("dim", "ffn_dim", "num_heads", "num_layers", "in_dim", "out_dim", "freq_dim",
             "text_len", "text_dim", "eps", "patch_size")


def port_fields(port_cfg, keys) -> dict:
    """`keys` of a port config, as the file writes them (tuples as lists)."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in ((k, getattr(port_cfg, k)) for k in keys)}


def check_port_sizes(cfg: dict) -> None:
    """The port's configs for the model name and the VAE entry must hold the
    file's sizes."""
    from gpubench import layout
    from realtime_video_tpu_torch.config import T5_CONFIGS, VAE_CONFIGS, WAN_CONFIGS

    for name, port_cfg, ref in (
            ("dit", WAN_CONFIGS[cfg["port"]["model_name"]], {k: cfg[k] for k in DIT_SIZES}),
            ("umt5", T5_CONFIGS["umt5-xxl"], cfg["text_encoder"]),
            ("vae", VAE_CONFIGS[layout.vae_name(cfg)], layout.vae_sizes(cfg))):
        have = port_fields(port_cfg, ref)
        if have != ref:
            raise SystemExit(f"the port's {name} config {have} is not the file's {ref}")


def install_weight_hooks(cfg: dict, seed: int) -> None:
    """The port's random-init functions draw the benchmark's weights instead.
    Each DiT the port makes is drawn at the sizes of the config it passes,
    keyed by its generator's seed less the run's (`weights.dit_params`' key):
    the port's DiT, made from the run's seed, has key 0; another DiT of the
    process, made from another seed, draws other weights, which the
    reference draws again from the same key."""
    from gpubench import weights
    from realtime_video_tpu_torch.models import t5 as t5_mod
    from realtime_video_tpu_torch.models import vae as vae_mod
    from realtime_video_tpu_torch.models import wan_dit

    def dit(port_cfg, gen, device=None, dtype=None):
        key = gen.initial_seed() - seed if gen is not None else 0
        return weights.dit_params(dict(cfg, **port_fields(port_cfg, DIT_SIZES)), seed,
                                  device, key)

    wan_dit.init_wan_params = dit
    t5_mod.init_t5_encoder_params = lambda _c, _g, device=None, dtype=None: \
        weights.t5_params(cfg["text_encoder"], seed, device)
    vae_mod.init_vae_params = lambda _c, _g, device=None, dtype=None: weights.vae_params(
        cfg["vae"], seed, device)


def server_config(cfg: dict, mix: dict):
    """The port's server config: the file's model and session, and the
    mix's placement of the port over the cards."""
    from realtime_video_tpu_torch.config import load_server_config

    s = cfg["session"]
    p = cfg["port"]
    return load_server_config(
        None, model_name=p["model_name"], checkpoint_path="", use_taehv=False,
        enable_int8=p["enable_int8"], enable_int8_dit=p["enable_int8_dit"],
        int8_static_scales=p["int8_static_scales"],
        num_denoising_steps=s["num_denoising_steps"], timestep_shift=s["timestep_shift"],
        kv_cache_num_frames=s["kv_cache_num_frames"], num_frame_per_block=s["num_frame_per_block"],
        **mix.get("placement", {}))


def used_devices(models) -> list:
    """The devices the port's models run on, the DiT's first."""
    from realtime_video_tpu_torch.serving.models import vae_devices

    return list(dict.fromkeys((models.transformer.device, *vae_devices(models.vae_decoder),
                               *vae_devices(models.vae_encoder))))


# ---------------------------------------------------------------------------
# the window's records
# ---------------------------------------------------------------------------


class SessionRecord:
    def __init__(self, spec, started: float):
        self.spec = spec
        self.started = started
        self.first_frame: Optional[float] = None
        self.block_last: Dict[int, float] = {}
        self.blocks_run = 0
        self.failed = False
        self.frames: Dict[int, np.ndarray] = {}  # kept for the check
        self.latents: Optional[np.ndarray] = None


class HostCopies:
    """One host thread that copies each frame tensor to NumPy, as the
    server's `to_host` does, and stamps it when the copy is done."""

    def __init__(self, check_block: int):
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.stamps: List[tuple] = []  # (stamp, frames, record, block)
        self.lock = threading.Lock()
        self.check_block = check_block
        self.futures = []

    @staticmethod
    def to_host(tensor) -> np.ndarray:
        """A frozen copy of the port's server `to_host` (serving/server.py)."""
        return np.clip((tensor.float().cpu().numpy() + 1.0) * 0.5, 0.0, 1.0)

    def frames(self, tensor, record: SessionRecord, block: int) -> None:
        def work():
            arr = self.to_host(tensor)
            stamp = time.perf_counter()
            with self.lock:
                self.stamps.append((stamp, arr.shape[1], record, block))
                if record.first_frame is None:
                    record.first_frame = stamp
                record.block_last[block] = stamp
                if block in (0, self.check_block):
                    prev = record.frames.get(block)
                    record.frames[block] = arr if prev is None else np.concatenate([prev, arr], 1)
                elif block == self.check_block - 1:
                    record.frames[block] = arr[:, 3:4]  # the re-encode's frame

        self.futures.append(self.pool.submit(work))

    def latents(self, tensor, record: SessionRecord) -> None:
        def work():
            record.latents = tensor.cpu().float().numpy()

        self.futures.append(self.pool.submit(work))

    def wait(self) -> None:
        """Until every copy handed over so far is done (its errors raised)."""
        while self.futures:
            self.futures.pop(0).result()

    def close(self) -> None:
        self.wait()
        self.pool.shutdown(wait=True)


class Spans:
    """CUDA-event spans around the port's layers, wrapped at run time
    (`--trace 1` only), and the host time of each generate_block. A span is
    timed on the card its layer runs on."""

    def __init__(self, torch):
        self.torch = torch
        self.events: Dict[str, list] = {}
        self.block = None  # (session index, block) being generated
        self.host_ms: Dict[tuple, float] = {}
        self.active = True  # off: calls run untimed

    def wrap(self, name: str, fn, card=None, others=()):
        """fn timed by events on `card`'s stream (default: the current
        card's). Where the call's first tensor lies on another card, the
        start waits for that card's queue, as the call's first copy from
        there would; the end waits for `others`, the further cards the call
        runs on."""
        torch = self.torch

        def timed(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            stream = torch.cuda.current_stream(card)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            first = next((a for a in args if isinstance(a, torch.Tensor)), None)
            if first is not None and first.is_cuda and first.device != stream.device:
                stream.wait_stream(torch.cuda.current_stream(first.device))
            start.record(stream)
            out = fn(*args, **kwargs)
            for other in others:
                stream.wait_stream(torch.cuda.current_stream(other))
            end.record(stream)
            self.events.setdefault(name, []).append((self.block, start, end))
            return out
        return timed

    def per_block_ms(self, name: str) -> Dict[tuple, float]:
        out: Dict[tuple, float] = {}
        for key, start, end in self.events.get(name, []):
            out[key] = out.get(key, 0.0) + start.elapsed_time(end)
        return out


class TextEncoderSpan:
    """The text encoder, its calls timed (a call goes through the type)."""

    def __init__(self, encoder, spans: Spans):
        self.call = spans.wrap("t5", encoder.__call__)

    def __call__(self, *args, **kwargs):
        return self.call(*args, **kwargs)


def install_spans(models, spans: Spans) -> None:
    from realtime_video_tpu_torch.serving import session as session_mod
    from realtime_video_tpu_torch.serving.models import vae_devices

    session_mod.block_step = spans.wrap("dit", session_mod.block_step)
    vae = models.vae_decoder
    card, *others = vae_devices(vae)  # split: timed on its first card, ended on all
    vae.decode_block = spans.wrap("vae", vae.decode_block, card, others)
    vae.encode_stream = spans.wrap("vae", vae.encode_stream, card, others)
    models.text_encoder = TextEncoderSpan(models.text_encoder, spans)


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------


def read_trace(prof, torch, span_name: str, cards: List[int]) -> dict:
    """Inside the span: each card's busy time and kernels; over all cards,
    device time by family and by kernel; the DiT's card's (`cards[0]`) busy
    time and its longest idle gaps, with the host operation running at
    each."""
    from gpubench import roofline

    events = prof.events()
    span = next(e for e in events if e.name == span_name)
    lo, hi = span.time_range.start, span.time_range.end
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != span_name and not getattr(e, "is_user_annotation", False)
            and lo <= e.time_range.start < hi]
    by_family = {f: 0.0 for f in roofline.FAMILIES}
    by_kernel: Dict[str, float] = {}
    kernels: Dict[int, list] = {c: [] for c in cards}  # [start us, end us, family]
    for e in cuda:
        us = e.time_range.end - e.time_range.start
        fam = roofline.family(e.name)
        by_family[fam] += us / 1e6
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us / 1e6
        kernels.setdefault(getattr(e, "device_index", cards[0]), []).append(
            [e.time_range.start, min(e.time_range.end, hi), fam])

    def busy_and_gaps(card):
        gaps, end, busy_us = [], lo, 0.0
        for start, stop, _ in sorted(kernels[card]):  # the union of the kernels, and its holes
            if start > end:
                gaps.append((end, start))
            busy_us += max(stop - max(start, end), 0.0)
            end = max(end, stop)
        if hi > end:
            gaps.append((end, hi))
        return busy_us / 1e6, gaps

    busy = {c: busy_and_gaps(c) for c in kernels}
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and e.name != span_name and lo <= e.time_range.start < hi]
    named = []
    for a, b in sorted(busy[cards[0]][1], key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        inside = [e for e in host if e.time_range.start <= mid < e.time_range.end]
        label = max(inside, key=lambda e: e.time_range.start).name if inside else "no host op"
        named.append([label[:120], (b - a) / 1e6])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy[cards[0]][0], "window_s": (hi - lo) / 1e6, "by_family_s": by_family,
            "device_ops": [[n[:160], s] for n, s in top], "idle_gaps": named,
            "dit_card": cards[0],
            "cards": {c: {"busy_s": busy[c][0], "kernels": kernels[c]} for c in kernels}}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def session_noise(torch, seed: int, index: int, shape, device):
    """A session's initial noise and its later draws, from one generator."""
    from gpubench.weights import sub_seed

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "session", index))
    noise = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    def noise_fn(shape_, dtype, device_):
        return torch.randn(shape_, generator=gen, dtype=torch.float32, device=device_).to(dtype)

    return noise, noise_fn


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile (inclusive quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def run(args, device: str = "cuda", cfg: Optional[dict] = None, mix: Optional[dict] = None,
        work: Optional[dict] = None) -> dict:
    """Set up, run the window, check; returns the result dict. `cfg`, `mix`
    and `work` default to the cell's files."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    if cfg is None:
        work, cfg, mix = find_cell(args.workload, manifest)
    prepare_environment(cfg)
    import torch

    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
            log(f"no CUDA card for {args.workload} (cuda available: "
                f"{torch.cuda.is_available()}, cards: {torch.cuda.device_count() if torch.cuda.is_available() else 0}, "
                f"needed: {work['chips']})")
            raise SystemExit(2)
        log(card_line(torch))
        check_port_sizes(cfg)
    from gpubench import check, layout, traffic_gen
    from realtime_video_tpu_torch.serving.models import load_all, warmup_models
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession

    seed = int(args.seed)
    install_weight_hooks(cfg, seed)
    s = cfg["session"]
    config = server_config(cfg, mix)
    models = load_all(config, device, seed)
    dev = models.transformer.device
    devices = used_devices(models)
    cards = [d.index for d in devices] if on_card else []
    if on_card and len(cards) != work["chips"]:
        raise SystemExit(f"{work['name']} asks for {work['chips']} cards and the port runs on "
                         f"{len(cards)}: {devices}")
    shape_of = lambda nb: layout.latent_shape(cfg, nb * s["num_frame_per_block"])  # noqa: E731
    copies = HostCopies(check.WARM_BLOCK)

    def params(spec):
        return GenerateParams(prompt=spec.prompt, width=s["width"], height=s["height"],
                              seed=spec.index, num_blocks=spec.num_blocks,
                              num_denoising_steps=s["num_denoising_steps"],
                              kv_cache_num_frames=s["kv_cache_num_frames"],
                              timestep_shift=s["timestep_shift"])

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    spans: Optional[Spans] = None

    def run_session(spec, record, deadline=None, after=None):
        """One session, block by block, until `deadline`; `after(b)` runs
        once block b is queued."""
        noise, noise_fn = session_noise(torch, seed, spec.index, shape_of(spec.num_blocks), dev)
        sess = GenerationSession(
            params(spec), config, models=models, noise=noise, noise_fn=noise_fn,
            frame_callback=lambda px, ids, ev: copies.frames(px, record, record.blocks_run))
        for b in range(spec.num_blocks):
            if b and deadline is not None and time.perf_counter() >= deadline:
                break
            if spans is not None:
                spans.block = (spec.index, b)
            t = time.perf_counter()
            sess.generate_block(models)
            if spans is not None and spans.active:
                spans.host_ms[(spec.index, b)] = (time.perf_counter() - t) * 1e3
            if after is not None:
                after(b)
            record.blocks_run = b + 1
        if record.blocks_run == spec.num_blocks:
            copies.latents(sess.all_latents, record)

    # -- warm-up: the port's, for this shape, then one 3-block session -------
    t_load = time.time() - PROCESS_START
    warmup_models(models, config, shapes=((s["width"], s["height"]),))
    warm = traffic_gen.SessionSpec(-1, "a warm up prompt of eight plain words here", 3)
    run_session(warm, SessionRecord(warm, 0.0))
    copies.wait()
    copies.stamps.clear()
    sync()
    if args.trace:
        spans = Spans(torch)
        install_spans(models, spans)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            (torch.ones(1, device=dev) + 1).sum().item()  # the profiler's own start-up
    records: List[SessionRecord] = []
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    setup_s = time.time() - PROCESS_START
    log(f"set-up {setup_s:.1f} s: to the models loaded {t_load:.1f} s "
        f"(load_all {models.load_seconds}), warm-up {setup_s - t_load:.1f} s")
    usage = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    t_end = t0 + float(args.seconds)

    # -- the window: a closed loop, each session started once the frames of
    # the one before are all on the host --------------------------------------
    plan = traffic_gen.sessions(mix, seed)
    for spec in plan:
        copies.wait()
        if time.perf_counter() >= t_end:
            break
        record = SessionRecord(spec, time.perf_counter())
        records.append(record)
        try:
            run_session(spec, record, deadline=t_end)
        except Exception:  # noqa: BLE001 — a failed session is counted, the loop goes on
            record.failed = True
            log(f"session {spec.index} failed:\n{traceback.format_exc()}")
    copies.wait()
    sync()
    peaks = {card: torch.cuda.max_memory_allocated(card) for card in cards}
    peak = max(peaks.values(), default=0)
    if len(cards) > 1:
        log("peak memory by card (bytes): " + json.dumps(peaks))
    # the window closes with the first block that completes at or after its
    # nominal end, so that a rate is taken over whole blocks
    t_close = min((t for r in records for t in r.block_last.values() if t >= t_end),
                  default=t_end)

    profiled = None
    if spans is not None:  # after the window: warm blocks 1-3 of one more session
        from torch.profiler import ProfilerActivity, profile, record_function

        spans.active = False
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        span = record_function("warm_blocks")

        def profile_blocks(b):
            if b == 0:
                sync()
                prof.__enter__()
                span.__enter__()
            elif b == 3:
                sync()
                span.__exit__(None, None, None)
                prof.__exit__(None, None, None)

        extra = next(plan)._replace(num_blocks=4)
        run_session(extra, SessionRecord(extra, time.perf_counter()), after=profile_blocks)
        copies.wait()
        profiled = read_trace(prof, torch, "warm_blocks", cards or [0])
    copies.close()

    # -- end-to-end metrics --------------------------------------------------
    seconds = t_close - t0
    metrics, gaps, frames, ttff, failed = window_metrics(copies.stamps, records, t_close, seconds)
    metrics["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    used = resource.getrusage(resource.RUSAGE_SELF)
    log(f"process in the window: user {used.ru_utime - usage.ru_utime:.1f} s, system "
        f"{used.ru_stime - usage.ru_stime:.1f} s, context switches voluntary "
        f"{used.ru_nvcsw - usage.ru_nvcsw}, involuntary {used.ru_nivcsw - usage.ru_nivcsw}")
    log(f"window {seconds} s: {len(records)} sessions started, {failed} failed, "
        f"{frames} frames, {len(ttff)} TTFF samples, {len(gaps)} block gaps "
        f"(blocks per session: {[r.blocks_run for r in records]})")
    log("TTFF by session (ms): " + json.dumps([round(t, 1) for t in ttff]))
    if gaps:
        top = sorted(gaps, key=lambda g: -g[2])[:8]
        by_block: Dict[int, list] = {}
        for _, b, g in gaps:
            by_block.setdefault(b + 1, []).append(g)
        log("block gaps: median by block " + json.dumps(
            {b: round(statistics.median(v), 1) for b, v in sorted(by_block.items())})
            + "; longest (block, ms) " + json.dumps([(b + 1, round(g, 1)) for _, b, g in top]))

    per_layer = None
    if spans is not None:
        per_layer = layer_metrics(cfg, work, manifest, spans, profiled, gaps, len(devices))

    # -- the check, after the program's state is freed ----------------------
    finished = [r for r in records if not r.failed and r.latents is not None]
    del models
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    control = getattr(args, "control", False)  # gpubench.control's runs only
    checks = check.check_sessions(cfg, mix, seed, finished, dev, control=control)
    what = ", the int4 control in the program's place" if control else ""
    log(f"check of {min(len(finished), mix.get('check_sessions', 1))} sessions{what}: "
        f"{time.perf_counter() - t_check:.1f} s")
    correct = bool(checks) and all(c["value"] <= c["limit"] for n, c in checks.items()
                                   if "." not in n)
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")

    keep = {m["name"] for m in manifest["end_to_end"]
            if work["name"] in m.get("workloads", [work["name"]])}
    result = {
        "correct": correct, "attempted": len(records), "failed": failed,
        "metrics": ({k: v for k, v in metrics.items() if k in keep and v["value"] is not None}
                    if not args.trace else per_layer["metrics"]),
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": len(devices), "memory_peak_bytes": int(peak)},
    }
    if args.trace and per_layer["breakdown"] is not None:
        busy = {c: profiled["cards"][c]["busy_s"] for c in cards}
        if len(busy) > 1:
            log("busy s in the profiled blocks by card: " + json.dumps(busy))
        result["device"].update(busy_s=statistics.mean(busy.values()),
                                window_s=profiled["window_s"])
        result["breakdown"] = per_layer["breakdown"]
    result["checks"] = checks
    return result


def window_metrics(stamps, records, t_end: float, seconds: float):
    """(fps / ttff_ms_p50 / block_gap_ms_p90, block gaps, frames, TTFFs,
    failed sessions) of the window closing at t_end: frames whose host copy
    was done by then over the window's length; each started session's time
    from construction to its first frame on the host (a late one counts);
    the gaps between the last frames of consecutive blocks of a session,
    both on the host by the close."""
    frames = sum(n for stamp, n, _, _ in stamps if stamp <= t_end)
    ttff = [(r.first_frame - r.started) * 1e3 for r in records
            if r.first_frame is not None and not r.failed]
    gaps = []
    for r in records:
        last = r.block_last
        for b in sorted(last):
            if b + 1 in last and last[b + 1] <= t_end:
                gaps.append((r.spec.index, b, (last[b + 1] - last[b]) * 1e3))
    failed = sum(1 for r in records if r.failed or r.first_frame is None)
    metrics = {
        "fps": {"value": frames / seconds, "unit": "frames/s"},
        "ttff_ms_p50": {"value": statistics.median(ttff) if ttff else None, "unit": "ms"},
        "block_gap_ms_p90": {"value": percentile([g for _, _, g in gaps], 90) if gaps else None,
                             "unit": "ms"},
    }
    return metrics, gaps, frames, ttff, failed


def layer_metrics(cfg, work, manifest, spans: Spans, profiled, gaps, cards: int) -> dict:
    """The per-layer metrics of the cell, each read by its own reader."""
    from gpubench import layout

    host = {k: v for k, v in spans.host_ms.items() if k[1] >= 1}
    dit = spans.per_block_ms("dit")
    vae = spans.per_block_ms("vae")
    run = {
        "session_host_ms": list(host.values()),
        "t5_ms": list(spans.per_block_ms("t5").values()),
        "dit_ms": [dit[k] for k in host if k in dit],
        "vae_ms": [vae[k] for k in host if k in vae],
        "profile": profiled,
        "profiled_blocks": 3,
        "work": layout.work(cfg),
        "warm_gaps_ms": [g for _, b, g in gaps if b >= 1],
        "cards": cards,
    }
    out = {}
    for m in manifest["per_layer"]:
        if work["name"] in m.get("workloads", [work["name"]]):
            value = metric_reader(m["name"])(run)
            if value is not None:  # a reader that finds nothing to read
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None if profiled is None else {"device_ops": profiled["device_ops"],
                                               "idle_gaps": profiled["idle_gaps"]}
    return {"metrics": out, "breakdown": breakdown}


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one the run may not load, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_process()
    result = run(args)
    found = forbidden_modules()
    if found:
        log(f"modules that the port's run may not load were loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
