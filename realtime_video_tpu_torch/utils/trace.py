"""Spans of the port's phases, kept in memory while recording is on.

    from realtime_video_tpu_torch.utils import trace

    trace.start()                          # or start(device_events=True)
    with trace.span("session.block", session_id, block_idx):
        ...
    records = trace.stop()                 # a list of Record, `.dropped` beside it

Off (the default), `span` reads one module flag and returns one shared
no-op object: nothing is allocated, formatted, timed or handed to the
profiler. On, each span becomes a `Record`:

  * its name, its id and its parent's id: a stack per thread, so that the
    sessions the server runs on its executor threads never nest into each
    other;
  * its attrs, the request it serves: `session` and `block`, given to a
    span that opens one (`session.setup`, `session.block`) and inherited
    from the parent by any other span;
  * the thread (`threading.get_ident()`), host start and end from
    `time.perf_counter_ns()`;
  * with `start(device_events=True)`, a pair of CUDA events recorded on the
    current stream at both ends (`Record.device_ms` after a synchronise).

While a torch.profiler session is active, each span also runs inside
`torch.profiler.record_function(name)`, so that the device trace carries the
program's phases on the profiler's own clock.

`timed(name)` is the span of a set-up step whose seconds the caller
keeps whether or not recording is on (`Span.seconds`): its record, when on,
holds the same stamps.

At most MAX_RECORDS records are kept from one `start`; the spans past them
are counted in `Records.dropped` and not recorded. A span still open at
`stop` keeps `end_ns` None until it closes.

Span names are fixed strings, one per phase; none sits below a phase (no
span in the per-layer loop of a forward, none around one kernel):

  session.setup          GenerationSession.__init__ (KV cache, schedule)
  session.block          one generate_block (attrs session, block)
  session.text_encode    the text encoder's call (block 0, a prompt change)
  session.cross_cache    the text K/V (`_initialize_crossattn_cache`)
  session.context        plan_block_context (with the anti-drift re-encode)
  session.webcam_encode  the pushed frames' stream encode
  session.emit           one frame_callback
  dit.block_step         serving's block_step: KV reset, prefill, denoise
  dit.prefill            wan_dit.context_prefill
  dit.step               one denoising step (a forward and the renoise)
  vae.decode             VAEWrapper.decode_block
  vae.encode             VAEWrapper.encode_stream
  vae.taehv_decode       the TAEHV preview tier's whole-block decode
  setup.load.<part>      load_all's transformer, text_encoder, vae
  setup.warmup.build     warmup_models' kernel library builds and loads
  setup.warmup.<W>x<H>   warmup_models' run of one shape
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

#: the most records kept from one `start`
MAX_RECORDS = 200_000

_on = False
_device_events = False
_records: "Records"
_next_id = 0
_lock = threading.Lock()
_local = threading.local()


class Records(list):
    """The records of one recording, in the order their spans opened;
    `dropped` counts the spans past MAX_RECORDS."""

    dropped = 0


_records = Records()


class Record:
    __slots__ = ("name", "id", "parent", "session", "block", "thread", "start_ns", "end_ns",
                 "events")

    def __init__(self, name, id_, parent, session, block):
        self.name = name
        self.id = id_
        self.parent = parent
        self.session = session
        self.block = block
        self.thread = threading.get_ident()
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.events = None

    def device_ms(self) -> Optional[float]:
        """CUDA-event ms between the span's ends (synchronise first), or None
        without device events."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "session": self.session, "block": self.block, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns}


class _Off:
    """The span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span while recording is on (or a `timed` step's stamps)."""

    __slots__ = ("name", "session", "block", "record", "range", "live", "start_ns", "end_ns")

    def __init__(self, name: str, session, block, live: bool):
        self.name = name
        self.session, self.block = session, block
        self.live = live
        self.record = self.range = None
        self.start_ns = self.end_ns = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        global _next_id
        if self.live:
            stack = _stack()
            parent = stack[-1] if stack else None
            if self.session is not None:
                session, block = self.session, self.block
            elif parent is not None:
                session, block = parent.session, parent.block
            else:
                session = block = None
            with _lock:
                _next_id += 1
                rec = Record(self.name, _next_id, parent.id if parent is not None else None,
                             session, block)
                if len(_records) < MAX_RECORDS:
                    _records.append(rec)
                else:
                    _records.dropped += 1
            stack.append(rec)
            self.record = rec
            if _device_events:
                rec.events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                rec.events[0].record()
            if torch.autograd.profiler._is_profiler_enabled:
                self.range = torch.profiler.record_function(self.name)
                self.range.__enter__()
        self.start_ns = time.perf_counter_ns()
        if self.record is not None:
            self.record.start_ns = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        rec = self.record
        if rec is not None:
            rec.end_ns = self.end_ns
            if self.range is not None:
                self.range.__exit__(*exc)
            if rec.events is not None:
                rec.events[1].record()
            stack = _stack()
            if stack and stack[-1] is rec:
                stack.pop()
        return False


def span(name: str, session=None, block=None):
    """A span of the phase `name` (see the module docstring), opening the
    request `session` (its `block`, if any) when given one; the shared
    no-op `OFF` while recording is off."""
    if not _on:
        return OFF
    return Span(name, session, block, True)


def timed(name: str) -> Span:
    """A span that takes its host stamps whether recording is on or not:
    for set-up steps whose seconds the caller reports (`Span.seconds`)."""
    return Span(name, None, None, _on)


def start(device_events: bool = False) -> None:
    """Start recording afresh (the records of an earlier recording are
    dropped); `device_events` adds a pair of CUDA events to each span."""
    global _on, _device_events, _records
    if device_events and not torch.cuda.is_available():
        raise RuntimeError("device events need a CUDA device")
    with _lock:
        _records = Records()
        _device_events = device_events
        _on = True


def stop() -> Records:
    """Stop recording; returns its records."""
    global _on, _records
    with _lock:
        _on = False
        out, _records = _records, Records()
    return out
