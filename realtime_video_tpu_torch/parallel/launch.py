"""Start, join and collect a group of ranks: the port's counterpart of the
JAX package's single controller.

    results = run(fn, world, *args, backend="nccl", device="cuda")

spawns `world` processes (the `spawn` start method: no CUDA context is ever
forked), initialises torch.distributed in each through a `file://` store in
a fresh temporary directory (no fixed port, so parallel test workers never
collide), calls fn(rank, world, *args) and returns each rank's result in
rank order. `fn` must be a module-level function of a module the children
can import, and its arguments and result must pickle (a result travels by
value, tensors included).

  * backend "nccl" (the default) puts one card under each rank and raises
    when the host has fewer cards than ranks; "gloo" with device "cpu" is
    the CPU path the tests take; "gloo" with device "cuda" lets several
    ranks share one card, which the caller chooses and names in its output
    (`collectives.py` says how gloo treats CUDA tensors). Nothing switches
    backend after a failure.
  * On a card the kernels' libraries are built here, in the parent, before
    any rank starts (`cuda_build.build_all`), and the ranks run with
    RTV_CUDA_NO_BUILD=1, so that a rank only loads a library and never
    compiles one into `_build/` beside another rank.
  * Every rank is joined with `timeout_s`: a rank that hangs, dies or
    raises makes `run` kill the others and raise, with the failing rank's
    traceback where it sent one.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

#: a rank reports (rank, "ok", result) or (rank, "error", traceback text)
_OK, _ERROR = "ok", "error"


def _entry(fn, rank: int, world: int, backend: str, device: str, init_file: str,
           timeout_s: float, args: tuple, results) -> None:
    os.environ["RTV_CUDA_NO_BUILD"] = "1"
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: the queue's own pickler would share a
        # tensor's storage through a file descriptor that dies with the rank
        results.put((rank, _OK, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        results.put((rank, _ERROR, traceback.format_exc()))
        raise


def kernel_sources() -> list:
    """The CUDA sources of the DiT's kernels (attention forward and
    backward, the int8 linear, the norm sites)."""
    from realtime_video_tpu_torch.ops import hopper_attention as hk
    from realtime_video_tpu_torch.ops import hopper_dit_norm as hdn
    from realtime_video_tpu_torch.ops import hopper_int8_mm as hm

    return [*hk.SOURCES, hm.SOURCE, hdn.SOURCE]


def run(fn: Callable[..., Any], world: int, *args, backend: str = "nccl",
        device: str = "cuda", init_file: Optional[str] = None,
        timeout_s: float = 600.0) -> List[Any]:
    """fn(rank, world, *args) on `world` spawned ranks; their results in
    rank order (see the module note)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("NCCL runs on cards: device='cuda'")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"NCCL needs a card a rank: {world} ranks, "
                               f"{torch.cuda.device_count()} cards (choose backend='gloo' "
                               "to share a card)")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' and backend='gloo'")
        from realtime_video_tpu_torch.ops import cuda_build

        cuda_build.build_all(kernel_sources())
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="rtv_launch_")
        init_file = os.path.join(tmp, "init")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, backend, device, init_file,
                                              timeout_s, args, results), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} of {world} "
                                   f"did not finish within {timeout_s} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a rank may have reported just before it exited
                    try:
                        rank, status, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                           f"{dead[0][1]} and reported nothing") from None
                else:
                    continue
            if status == _ERROR:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            got[rank] = pickle.loads(payload)
        for r, p in enumerate(procs):
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
            if p.exitcode is None:
                raise TimeoutError(f"rank {r} reported but did not exit within {timeout_s} s")
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
