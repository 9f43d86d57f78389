"""The port's spans (`utils/trace.py`) on the CPU, on tests/test_torch_session.py's
tiny bf16 models:

  * off (the default), a session records nothing, builds no span object and
    never enters `record_function`, even under a profiler: `span` is one
    flag read and the shared no-op object, and no call site builds anything
    for it (no `**attrs` dict, no formatted name: checked on the source);
  * on, a 3-block session gives, per block, the documented span tree
    (`session.block` over `session.context`, `dit.block_step` with its
    prefill and 4 `dit.step`, 3 `vae.decode`, the emits), each span carrying
    the session's id and its block;
  * spans of two threads nest each into its own thread's spans;
  * under a CPU torch.profiler session the spans are profiler events, nested
    as they were opened;
  * `load_all` and `warmup_models` record the `setup.*` spans from the stamps
    their returned seconds come from; the cap drops and counts.
"""
import ast
import inspect
import threading
from pathlib import Path

import pytest
import torch

from realtime_video_tpu_torch.serving import models as models_mod
from realtime_video_tpu_torch.serving.params import GenerateParams
from realtime_video_tpu_torch.serving.session import GenerationSession
from realtime_video_tpu_torch.utils import trace
from test_torch_session import REQ, one_torch_thread, stacks  # noqa: F401


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with recording off."""
    trace.stop()
    yield
    trace.stop()


def _raise(*a, **k):
    raise AssertionError("called while the tracer is off")


def _session(config, models, blocks=3):
    frames = []
    s = GenerationSession(GenerateParams(**dict(REQ, num_blocks=blocks)), config,
                          models=models, frame_callback=lambda px, ids, ev: frames.append(px))
    for _ in range(blocks):
        s.generate_block(models)
    return s, frames


def _tree(records, rec):
    """(name, [child trees]) of `rec`, children in the order they opened."""
    return (rec.name, [_tree(records, r) for r in records if r.parent == rec.id])


def _span_calls():
    """(file, line, call) of every `trace.span(...)` in the port's package."""
    root = Path(trace.__file__).resolve().parents[1]
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "trace"):
                yield path.name, node.lineno, node


def test_off_records_nothing_and_never_calls_record_function(stacks, monkeypatch):  # noqa: F811
    config, _, tm = stacks
    assert trace.span("dit.step") is trace.OFF
    with trace.span("session.block", 1, 0) as sp:
        assert sp is trace.OFF
    # off, a call builds nothing: `span` takes no *args / **kwargs, and every
    # call site passes a fixed name and at most the request's ids as they are
    kinds = {p.kind for p in inspect.signature(trace.span).parameters.values()}
    assert kinds == {inspect.Parameter.POSITIONAL_OR_KEYWORD}
    sites = list(_span_calls())
    assert len(sites) >= 14
    for name, line, call in sites:
        assert not call.keywords and len(call.args) <= 3, (name, line)
        assert isinstance(call.args[0], ast.Constant) and isinstance(call.args[0].value, str)
        assert all(isinstance(a, (ast.Name, ast.Attribute)) for a in call.args[1:]), \
            (name, line)
    monkeypatch.setattr(trace, "Span", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _session(config, tm, blocks=2)
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.split(".")[0] in ("session", "dit", "vae", "setup")}
    assert trace.stop() == []


def test_a_session_records_the_documented_span_tree(stacks, monkeypatch):  # noqa: F811
    """Blocks 0-2 of a session, no profiler (record_function raises):
    block 0 encodes the prompt and builds its text K/V, has no context to
    prefill and sends its 6 frames as its 2nd and 3rd latents are decoded
    (the 1st latent's frame is dropped); blocks 1 and 2 prefill
    their context and send 12 frames in one, block 2 re-encoding its first
    context frame under `session.context`."""
    config, _, tm = stacks
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    trace.start()
    s, frames = _session(config, tm)
    records = trace.stop()
    assert records.dropped == 0
    assert all(r.end_ns >= r.start_ns for r in records)
    setup = [r for r in records if r.name == "session.setup"]
    assert len(setup) == 1 and setup[0].parent is None
    assert (setup[0].session, setup[0].block) == (s.session_id, None)

    blocks = [r for r in records if r.name == "session.block"]
    assert [(r.session, r.block, r.parent) for r in blocks] == \
        [(s.session_id, b, None) for b in range(3)]
    steps = [("dit.step", [])] * 4
    tail = [("vae.decode", [])] * 3
    want = {
        0: [("session.text_encode", []), ("session.cross_cache", []),
            ("session.context", []), ("dit.block_step", steps)]
           + [("vae.decode", [])] * 2 + [("session.emit", []), ("vae.decode", []),
                                         ("session.emit", [])],
        1: [("session.context", []), ("dit.block_step", [("dit.prefill", [])] + steps)]
           + tail + [("session.emit", [])],
        2: [("session.context", [("vae.encode", [])]),
            ("dit.block_step", [("dit.prefill", [])] + steps)] + tail + [("session.emit", [])],
    }
    for b, rec in enumerate(blocks):
        assert _tree(records, rec) == ("session.block", want[b])
        inside = [r for r in records if r.block == b]
        assert all(r.session == s.session_id for r in inside)
        assert sum(r.name == "vae.decode" for r in inside) == 3
        assert sum(r.name == "dit.step" for r in inside) == 4
    assert [f.shape[1] for f in frames] == [2, 4, 12, 12]
    assert s.total_frames_sent == 30


def test_prompt_change_and_emits_are_spans_of_their_block(stacks):  # noqa: F811
    """A prompt lerped over 2 blocks: each of blocks 1 and 2 rebuilds its
    text K/V (`session.cross_cache`); the new prompt's encode is a span of
    no block (it runs between blocks)."""
    config, _, tm = stacks
    s = GenerationSession(GenerateParams(**REQ), config, models=tm,
                          frame_callback=lambda px, ids, ev: None)
    trace.start()
    s.generate_block(tm)
    s.interpolate_prompt_embeds(tm, "a dog", 2)
    s.generate_block(tm)
    s.generate_block(tm)
    records = trace.stop()
    encodes = [(r.block, r.parent) for r in records if r.name == "session.text_encode"]
    assert encodes[0][0] == 0 and encodes[1] == (None, None)
    assert [r.block for r in records if r.name == "session.cross_cache"] == [0, 1, 2]
    assert [r.block for r in records if r.name == "session.emit"] == [0, 0, 1, 2]


def test_spans_of_two_threads_keep_separate_parents():
    barrier = threading.Barrier(2, timeout=10)
    trace.start()

    def work(i):
        with trace.span("session.block", session=i, block=i):
            barrier.wait()
            with trace.span("dit.block_step"):
                barrier.wait()
                with trace.span("dit.step"):
                    barrier.wait()

    threads = [threading.Thread(target=work, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    records = trace.stop()
    assert len(records) == 6
    by_id = {r.id: r for r in records}
    for r in records:
        if r.name == "session.block":
            assert r.parent is None
        else:
            parent = by_id[r.parent]
            assert parent.thread == r.thread and parent.session == r.session == r.block
            assert parent.name == {"dit.block_step": "session.block",
                                   "dit.step": "dit.block_step"}[r.name]
    assert len({r.thread for r in records}) == 2


def test_spans_are_profiler_events_under_a_profiler(stacks):  # noqa: F811
    config, _, tm = stacks
    trace.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _session(config, tm, blocks=2)
    records = trace.stop()
    events = [e for e in prof.events() if e.name.split(".")[0] in ("session", "dit", "vae")]
    assert sorted(e.name for e in events) == sorted(r.name for r in records)
    outer = [e for e in events if e.name == "dit.block_step"]
    for e in events:
        if e.name in ("dit.step", "dit.prefill"):
            assert any(o.time_range.start <= e.time_range.start
                       and e.time_range.end <= o.time_range.end for o in outer)
    assert sum(e.name == "vae.decode" for e in events) == 6


def test_load_all_and_warmup_record_setup_spans(stacks, monkeypatch):  # noqa: F811
    config, _, tm = stacks
    monkeypatch.setattr(models_mod, "load_transformer", lambda *a, **k: tm.transformer)
    monkeypatch.setattr(models_mod, "load_text_encoder", lambda *a, **k: tm.text_encoder)
    monkeypatch.setattr(models_mod, "load_vae", lambda *a, **k: tm.vae_decoder)
    trace.start()
    m = models_mod.load_all(config, "cpu")
    warm = models_mod.warmup_models(m, config, shapes=((64, 32),))
    records = trace.stop()
    by_name = {r.name: r for r in records}
    assert set(m.load_seconds) == {"transformer", "text_encoder", "vae"}
    for part, seconds in m.load_seconds.items():
        rec = by_name[f"setup.load.{part}"]
        assert rec.parent is None and seconds == (rec.end_ns - rec.start_ns) / 1e9
    seconds = {name: (r.end_ns - r.start_ns) / 1e9 for name, r in by_name.items()}
    assert warm["build_s"] == seconds["setup.warmup.build"]
    assert warm["shapes"] == {"64x32": seconds["setup.warmup.64x32"]}
    shape = by_name["setup.warmup.64x32"]
    inside = [r.name for r in records if r.parent == shape.id]
    assert inside == ["dit.block_step", "vae.decode", "vae.decode", "dit.block_step"] \
        + ["vae.decode"] * 3 + ["vae.encode"]


def test_timed_keeps_its_seconds_with_the_tracer_off():
    with trace.timed("setup.warmup.build") as span:
        sum(range(1000))
    assert span.seconds > 0 and trace.stop() == []


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    trace.start()
    for i in range(5):
        with trace.span("session.emit"):
            pass
    records = trace.stop()
    assert len(records) == 3 and records.dropped == 2
    trace.start()
    assert trace.stop().dropped == 0


def test_device_events_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trace.start(device_events=True)
    assert trace.span("dit.step") is trace.OFF
