"""What six per-layer readers read from the port's own spans
(`realtime_video_tpu_torch/utils/trace.py`) in a traced run.

`gpubench/run.py` does not start the port's tracer yet: under `--trace 1`
it times the port's layers from outside (`Spans`). A run that starts the
tracer before `load_all`, stops it after the profiled blocks and adds
`run_keys(records, attribute(prof.events(), "warm_blocks", DeviceType.CUDA))`
to the readers' `run` dict gives them:

  program_spans   the window's sessions' records, as dicts (the warm-up
                  session, the first, and the profiled one, the last, left
                  out)
  span_busy_ms    device-busy ms over the profiled blocks, by the family of
                  the span ("dit", "vae", "session", "setup") in which the
                  CUDA API call that launched each kernel lies, and
                  "unattributed" for kernels whose launch lies in none
  profiled_blocks (run.py's own key) the blocks the profile holds

A kernel is tied to its launch by kineto's correlation id (the kernel's
`id` is its launch call's); the launch call lies in the innermost span of
the program's that was open on its thread when it ran, on the profiler's
clock, as the tracer enters `record_function` for each span while a
profiler runs. A copy to the host is never charged to a span: the program
makes none in a warm block (it has no host sync there), while the harness's
host-copy thread makes one for each frame tensor, and the profiler reports
that thread's calls under the session thread's id, inside whatever span is
open there. The copy is all that thread launches (the frames reach
`to_host` in float32, so its `.float()` runs no kernel), so its work is
told apart by what it launched and goes to "unattributed".
"""
from __future__ import annotations

import bisect
import re
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the families of the program's span names (the part before the first dot)
FAMILIES = ("session", "dit", "vae", "setup")
#: a CUDA API call, runtime or low-level (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync)
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
#: a copy from the device to the host, as kineto names it
TO_HOST = re.compile(r"^Memcpy DtoH")


def family(name: str) -> Optional[str]:
    head, dot, _ = name.partition(".")
    return head if dot and head in FAMILIES else None


# ---------------------------------------------------------------------------
# intervals
# ---------------------------------------------------------------------------


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


class Cover:
    """Sorted disjoint intervals, asked how much of [a, b) they cover."""

    def __init__(self, intervals: Sequence[Tuple[float, float]]):
        self.starts = [a for a, _ in intervals]
        self.ends = [b for _, b in intervals]
        self.before = [0.0]
        for a, b in intervals:
            self.before.append(self.before[-1] + b - a)

    def covered(self, a: float, b: float) -> float:
        def upto(t):  # covered length of (-inf, t)
            i = bisect.bisect_right(self.starts, t)
            if i == 0:
                return 0.0
            return self.before[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]
        return max(upto(b) - upto(a), 0.0) if b > a else 0.0


# ---------------------------------------------------------------------------
# the records (host clock)
# ---------------------------------------------------------------------------


def _warm(r: dict) -> bool:
    return r["block"] is not None and r["block"] >= 1 and r["end_ns"] is not None


def block_host_ms(records: List[dict], names: Iterable[str]) -> List[float]:
    """For each warm block (block >= 1), in order, the host ms that its spans
    named `names` cover (their union)."""
    names = set(names)
    blocks: Dict[tuple, list] = {}
    for r in records:
        if r["name"] in names and _warm(r):
            blocks.setdefault((r["session"], r["block"]), []).append((r["start_ns"], r["end_ns"]))
    return [length(merged(v)) / 1e6 for _, v in sorted(blocks.items())]


def self_ms(records: List[dict], name: str) -> List[float]:
    """For each warm span named `name`, in order, its host ms less the union
    of its children's (each clipped to it)."""
    children: Dict[int, list] = {}
    for r in records:
        if r["end_ns"] is not None:
            children.setdefault(r["parent"], []).append(r)
    out = []
    for r in records:
        if r["name"] == name and _warm(r):
            lo, hi = r["start_ns"], r["end_ns"]
            inner = merged((max(c["start_ns"], lo), min(c["end_ns"], hi))
                           for c in children.get(r["id"], ()))
            out.append((hi - lo - length(inner)) / 1e6)
    return out


def host_ms(records: List[dict], name: str) -> List[float]:
    """The host ms of each closed span named `name`, in order."""
    return [(r["end_ns"] - r["start_ns"]) / 1e6 for r in records
            if r["name"] == name and r["end_ns"] is not None]


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


# ---------------------------------------------------------------------------
# the device trace (the profiler's clock, us)
# ---------------------------------------------------------------------------


def attribute(events, range_name: str, device_type) -> dict:
    """Device time inside the host range `range_name` by the family of the
    span its launches lie in (see the module docstring), in ms:

      busy_ms         {family or "unattributed": union of its kernels' time}
      self_host_ms    {family, or "none": host ms}, the range split by the
                      innermost span open on the thread whose spans cover
                      most of it
      idle_ms         the same split of the time no kernel ran
      unattributed    the 5 kernels of most unattributed time: [name, ms]

    `events` are torch.profiler FunctionEvents (or objects with their
    name, id, device_type, thread, time_range and is_user_annotation);
    `device_type` is the device's DeviceType. Kernels are those starting
    in the range, clipped at its end, as read_trace takes them; its busy
    time and idle gaps are read_trace's."""
    span = next(e for e in events if e.name == range_name)
    lo, hi = span.time_range.start, span.time_range.end
    kernels = [e for e in events if e.device_type == device_type and e.name != range_name
               and not getattr(e, "is_user_annotation", False)
               and lo <= e.time_range.start < hi]
    host = [e for e in events if e.device_type != device_type]
    runtime = {e.id: e for e in host if RUNTIME.match(e.name)}
    phases: Dict[int, list] = {}
    for e in host:
        if family(e.name):
            phases.setdefault(e.thread, []).append(e)

    def innermost(thread, t):
        inside = [p for p in phases.get(thread, ()) if p.time_range.start <= t < p.time_range.end]
        return max(inside, key=lambda p: p.time_range.start) if inside else None

    by_key: Dict[str, list] = {}
    orphans: Dict[str, float] = {}
    for k in kernels:
        call = runtime.get(k.id)
        phase = (innermost(call.thread, call.time_range.start)
                 if call is not None and not TO_HOST.match(k.name) else None)
        key = family(phase.name) if phase is not None else "unattributed"
        by_key.setdefault(key, []).append((k.time_range.start, min(k.time_range.end, hi)))
        if phase is None:
            orphans[k.name[:80]] = orphans.get(k.name[:80], 0.0) + (
                min(k.time_range.end, hi) - k.time_range.start) / 1e3
    cover = Cover(merged(iv for v in by_key.values() for iv in v))

    # the range split by the innermost span open on the thread that holds most of them
    main = max(phases, key=lambda t: sum(p.time_range.end - p.time_range.start
                                         for p in phases[t]), default=None)
    mine = phases.get(main, [])
    cuts = sorted({lo, hi} | {min(max(t, lo), hi) for p in mine
                              for t in (p.time_range.start, p.time_range.end)})
    self_host: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        phase = innermost(main, (a + b) / 2)
        key = family(phase.name) if phase is not None else "none"
        self_host[key] = self_host.get(key, 0.0) + (b - a) / 1e3
        idle[key] = idle.get(key, 0.0) + (b - a - cover.covered(a, b)) / 1e3
    return {"busy_ms": {k: length(merged(v)) / 1e3 for k, v in sorted(by_key.items())},
            "self_host_ms": self_host, "idle_ms": idle,
            "unattributed": sorted(([n, ms] for n, ms in orphans.items()),
                                   key=lambda row: -row[1])[:5]}


# ---------------------------------------------------------------------------
# the readers' keys
# ---------------------------------------------------------------------------


def window_records(records: List[dict]) -> List[dict]:
    """The records of the window's sessions: run.py builds one warm-up
    session before the window and one profiled session after it."""
    ids = sorted({r["session"] for r in records if r["name"] == "session.setup"})
    window = set(ids[1:-1])
    return [r for r in records if r["session"] in window]


def run_keys(records, attribution: Optional[dict], profiled_blocks: int = 3) -> dict:
    """The keys the six readers read (see the module docstring)."""
    return {"program_spans": window_records([r.as_dict() for r in records]),
            "span_busy_ms": None if attribution is None else attribution["busy_ms"],
            "profiled_blocks": profiled_blocks}
