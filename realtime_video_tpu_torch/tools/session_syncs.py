"""Count the calls that make the host wait for a card in one warm serving
block, and time a session's blocks as the server meets them. A library for
scripts on a card (`chip_smoke.py`'s `session_megafuse` and `vae_multi_gpu`
phases call it); it has no command line.

`torch.cuda.set_sync_debug_mode("warn")` makes each synchronising CUDA call
(a blocking copy between host and card, a stream or device synchronize,
`.item()`, `nonzero`) warn; `count_syncs` counts those warnings and names the
line of the package that made each. `warm_block_syncs` runs a session of 3
blocks and counts block 2's (the first warm block with the anti-drift
re-encode), from the entry of `generate_block_internal` to its return, with
a frame callback that does nothing.

`timed_session` drives a session as the server does: each callback's
frames are copied to the host on a worker thread (`tensor.float().cpu()`,
as `serving/server.py`'s callback does in its encode pool), and it reports
the time to the first frame on the host, each block's wall (from one
block's last frame on the host to the next's), the warm frame rate, and
per block the host's time inside `generate_block_internal` beside the
card's time between CUDA events recorded at its entry and return.
"""
from __future__ import annotations

import os
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

SYNC_MESSAGE = "called a synchronizing CUDA operation"
PACKAGE = "realtime_video_tpu_torch"
REQUEST = {"prompt": "a red fox running through snow", "width": 832, "height": 480,
           "seed": 7, "num_denoising_steps": 4, "kv_cache_num_frames": 3}


def _site(stack) -> str:
    """The innermost frame of the package (not this file) that made the
    call: "path:line  source"."""
    here = os.path.abspath(__file__)
    for fr in reversed(stack):
        path = os.path.abspath(fr.filename)
        if f"{os.sep}{PACKAGE}{os.sep}" in path and path != here:
            rel = path[path.rindex(f"{os.sep}{PACKAGE}{os.sep}") + 1:]
            return f"{rel}:{fr.lineno}  {fr.line}"
    fr = stack[-1]
    return f"{fr.filename}:{fr.lineno}  {fr.line}"


def count_syncs(fn, mode: str = "warn"):
    """(fn(), {"count": synchronising calls, "sites": {site: count}}) with
    the sync debug mode at `mode` while fn runs ("error" raises at the first
    one) and reset to "default" after."""
    sites: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            site = _site(traceback.extract_stack()[:-1])
            sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode(mode)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, {"count": sum(sites.values()), "sites": sites}


def _megafuse(value: str):
    """Set RTV_SESSION_MEGAFUSE; returns the previous value (None: unset)."""
    prev = os.environ.get("RTV_SESSION_MEGAFUSE")
    os.environ["RTV_SESSION_MEGAFUSE"] = value
    return prev


def _restore(prev) -> None:
    if prev is None:
        os.environ.pop("RTV_SESSION_MEGAFUSE", None)
    else:
        os.environ["RTV_SESSION_MEGAFUSE"] = prev


def warm_block_syncs(models, config, request=None, megafuse: str = "1", mode: str = "warn",
                     block: int = 2) -> dict:
    """Block `block` of a session on `models`, counted by `count_syncs` in
    `mode`, with RTV_SESSION_MEGAFUSE at `megafuse`; the blocks before it
    run uncounted. Returns the count, the sites and the frames the block
    sent."""
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession

    prev = _megafuse(megafuse)
    sent = []
    try:
        with torch.no_grad():
            s = GenerationSession(GenerateParams(**dict(request or REQUEST, num_blocks=block + 1)),
                                  config, models=models,
                                  frame_callback=lambda px, ids, ev: sent.append(px.shape[1]))
            for _ in range(block):
                s.generate_block_internal(models)
            del sent[:]
            _, res = count_syncs(lambda: s.generate_block_internal(models), mode)
    finally:
        _restore(prev)
    torch.cuda.synchronize()
    return dict(res, block=block, frames_per_callback=list(sent))


def timed_session(models, config, request=None, blocks: int = 5, megafuse: str = "1",
                  keep_frames: bool = False) -> dict:
    """A session of `blocks` blocks driven back to back, its frames copied to
    the host on a worker thread as the server's callback does. Returns
    ttff_ms, block_ms (block 0 from the start, then last frame to last
    frame), fps_warm, host_ms / device_ms per block (the time inside
    `generate_block_internal`, and the card's between events at its entry
    and return on the current stream), the latents (CPU, f32) and, with
    `keep_frames`, the frames on the host."""
    from realtime_video_tpu_torch.serving.params import GenerateParams
    from realtime_video_tpu_torch.serving.session import GenerationSession

    pool = ThreadPoolExecutor(1)
    arrivals, futures = [], []

    def to_host(px, block):
        arr = px.float().cpu()
        arrivals.append((block, time.perf_counter()))
        return arr

    prev = _megafuse(megafuse)
    try:
        with torch.no_grad():
            s = GenerationSession(
                GenerateParams(**dict(request or REQUEST, num_blocks=blocks)), config,
                models=models,
                frame_callback=lambda px, ids, ev: futures.append(
                    pool.submit(to_host, px, s.block_idx)))
            torch.cuda.synchronize()
            host, events = [], []
            t0 = time.perf_counter()
            for _ in range(blocks):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                e0.record()
                s.generate_block_internal(models)
                e1.record()
                host.append((time.perf_counter() - h0) * 1e3)
                events.append((e0, e1))
            frames = [f.result() for f in futures]
            torch.cuda.synchronize()
    finally:
        _restore(prev)
        pool.shutdown()
    ends = [max(t for b, t in arrivals if b == i) for i in range(blocks)]
    first = min(t for _, t in arrivals)
    out = dict(megafuse=megafuse, blocks=blocks, ttff_ms=(first - t0) * 1e3,
               block_ms=[(b - a) * 1e3 for a, b in zip([t0] + ends, ends)],
               fps_warm=12 * (blocks - 1) / (ends[-1] - ends[0]) if blocks > 1 else None,
               host_ms=host, device_ms=[a.elapsed_time(b) for a, b in events],
               frames_per_callback=[f.shape[1] for f in frames],
               latents=s.all_latents.float().cpu())
    if keep_frames:
        out["frames"] = torch.cat(frames, dim=1)
    return out
