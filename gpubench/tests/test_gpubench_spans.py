"""The six span readers and `gpubench/spans.py` on synthetic records and a fake
trace: self time under overlapping children, per-block unions, kernels
tied to their launch calls by correlation id and to the innermost span on
the launching thread, copies to the host and kernels without a launch call
left unattributed, and readers that find no spans."""
from types import SimpleNamespace

import pytest

from gpubench import run, spans

CPU, CUDA = "cpu", "cuda"
SIX = ("dit_host_ms", "vae_host_ms", "session_self_ms", "dit_busy_ms", "vae_busy_ms",
       "session_setup_ms")


def rec(id_, name, parent, start_ms, end_ms, session=7, block=1):
    return {"name": name, "id": id_, "parent": parent, "session": session, "block": block,
            "thread": 1, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6)}


def block(first_id, block_idx, t0):
    """A warm block at t0 ms: 100 ms of session.block whose children overlap
    (context 0-10 with its re-encode 2-8, DiT 5-60, decodes 62-70, 70-80,
    85-90, emit 95-100): self time 100 - 60 - 18 - 5 - 5 = 12 ms."""
    i = first_id
    rows = [rec(i, "session.block", None, t0, t0 + 100, block=block_idx),
            rec(i + 1, "session.context", i, t0, t0 + 10, block=block_idx),
            rec(i + 2, "vae.encode", i + 1, t0 + 2, t0 + 8, block=block_idx),
            rec(i + 3, "dit.block_step", i, t0 + 5, t0 + 60, block=block_idx),
            rec(i + 4, "dit.step", i + 3, t0 + 10, t0 + 20, block=block_idx)]
    rows += [rec(i + 5 + k, "vae.decode", i, t0 + a, t0 + b, block=block_idx)
             for k, (a, b) in enumerate(((62, 70), (70, 80), (85, 90)))]
    rows.append(rec(i + 8, "session.emit", i, t0 + 95, t0 + 100, block=block_idx))
    return rows


def window():
    return ([rec(1, "session.setup", None, 0, 4, block=None)] + block(10, 0, 10)
            + block(20, 1, 120) + block(30, 2, 230))


def test_self_time_is_the_span_less_the_union_of_its_children():
    records = window()
    assert spans.self_ms(records, "session.block") == pytest.approx([12.0, 12.0])
    assert run.metric_reader("session_self_ms")({"program_spans": records}) == \
        pytest.approx(12.0)


def test_host_readers_take_the_union_per_warm_block():
    records = window()
    # the re-encode (6 ms) and the three decodes (8 + 10 + 5) a block
    assert spans.block_host_ms(records, ("vae.decode", "vae.encode")) == \
        pytest.approx([29.0, 29.0])
    keys = {"program_spans": records}
    assert run.metric_reader("vae_host_ms")(keys) == pytest.approx(29.0)
    assert run.metric_reader("dit_host_ms")(keys) == pytest.approx(55.0)
    assert run.metric_reader("session_setup_ms")(keys) == pytest.approx(4.0)


def test_window_records_leave_out_the_warm_up_and_the_profiled_session():
    records = [rec(i, "session.setup", None, i, i + 1, session=s, block=None)
               for i, s in enumerate((3, 4, 5, 6))]
    records.append(rec(9, "session.block", None, 10, 20, session=5, block=1))
    assert [r["session"] for r in spans.window_records(records)] == [4, 5, 5]


def ev(name, id_, start_us, end_us, thread=1, device=CPU, annotation=False):
    return SimpleNamespace(name=name, id=id_, thread=thread, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def fake_trace():
    """A 2000 us range: the session's span 0-1000 on thread 1 with a DiT span
    100-600 and a decode 650-900; kernels launched by cudaLaunchKernel or
    cuLaunchKernel (the hand kernels' low-level call) inside each, one by a copy
    on thread 2 inside no span, one whose launch the trace lacks, one that
    starts after the range, and two calls of the host-copy thread that the
    profiler reports on thread 1: a copy to the host inside the decode,
    crossing no event there, and a sync that starts inside the decode's
    launch and outlasts it (that launch is the session's all the same)."""
    host = [ev("warm_blocks", 1, 0, 2000), ev("session.block", 2, 0, 1000),
            ev("dit.block_step", 3, 100, 600), ev("dit.step", 4, 150, 550),
            ev("vae.decode", 5, 650, 900), ev("aten::mul", 6, 160, 170),
            ev("cudaLaunchKernel", 11, 162, 165), ev("cuLaunchKernel", 12, 300, 302),
            ev("cudaLaunchKernel", 13, 700, 705), ev("cudaLaunchKernel", 14, 950, 955),
            ev("cudaMemcpyAsync", 15, 400, 410, thread=2),
            ev("cudaMemcpyAsync", 17, 660, 680), ev("cudaStreamSynchronize", 18, 703, 800)]
    device = [ev("mul_kernel", 11, 200, 300, device=CUDA),
              ev("int8_linear_kernel", 12, 300, 500, device=CUDA),
              ev("conv_kernel", 13, 800, 1000, device=CUDA),
              ev("elementwise", 14, 1000, 1050, device=CUDA),
              ev("Memcpy DtoH", 15, 1100, 1150, device=CUDA),
              ev("orphan", 99, 1200, 1230, device=CUDA),
              ev("warm_blocks", 1, 0, 2000, device=CUDA, annotation=True),
              ev("late", 16, 2100, 2200, device=CUDA),
              ev("Memcpy DtoH", 17, 1250, 1300, device=CUDA)]
    return host + device


def test_kernels_go_to_the_innermost_span_of_their_launch_call():
    got = spans.attribute(fake_trace(), "warm_blocks", CUDA)
    assert got["busy_ms"] == pytest.approx({"dit": 0.3, "vae": 0.2, "session": 0.05,
                                            "unattributed": 0.13})
    assert got["unattributed"] == [["Memcpy DtoH", pytest.approx(0.1)],
                                   ["orphan", pytest.approx(0.03)]]
    # the families partition the busy time (read_trace's busy_s)
    assert sum(got["busy_ms"].values()) == pytest.approx(0.68)
    # the range split by the innermost span on the main thread
    assert got["self_host_ms"] == pytest.approx({"session": 0.25, "dit": 0.5, "vae": 0.25,
                                                 "none": 1.0})
    # idle: the session's 0-100 and 600-650, the DiT's 100-200 and 500-600,
    # the decode's 650-800, and 820 us of 1000-2000 after the spans
    assert got["idle_ms"] == pytest.approx({"session": 0.15, "dit": 0.2, "vae": 0.15,
                                            "none": 0.82})
    assert sum(got["idle_ms"].values()) == pytest.approx(2.0 - 0.68)


def test_busy_readers_per_profiled_block_and_none_without_spans():
    att = spans.attribute(fake_trace(), "warm_blocks", CUDA)
    keys = spans.run_keys([], att, profiled_blocks=2)
    assert keys["program_spans"] == []
    assert run.metric_reader("dit_busy_ms")(keys) == pytest.approx(0.15)
    assert run.metric_reader("vae_busy_ms")(keys) == pytest.approx(0.1)
    for name in SIX:  # a program with no spans, a run that did not trace
        read = run.metric_reader(name)
        assert read({"program_spans": [], "span_busy_ms": {}, "profiled_blocks": 3}) is None
        assert read({"profiled_blocks": 3}) is None


def card_trace():
    """Kernels of three cards inside a 1000 us range: the DiT's card 0 runs
    0-100 and 200-300 and a copy 100-150; card 1 runs 50-120 and 250-260,
    card 2 400-420."""
    import torch

    gpu = torch.autograd.DeviceType.CUDA

    def k(name, start, end, card):
        e = ev(name, 0, start, end, device=gpu)
        e.device_index = card
        return e

    return [ev("warm_blocks", 1, 0, 1000, device=torch.autograd.DeviceType.CPU),
            k("int8_linear_kernel", 0, 100, 0), k("Memcpy PtoP", 100, 150, 0),
            k("attention_kernel", 200, 300, 0), k("conv_kernel<3, 1>", 50, 120, 1),
            k("conv_kernel<3, 1>", 250, 260, 1), k("conv_kernel<3, 1>", 400, 420, 2)]


def test_the_trace_keeps_each_cards_kernels_apart():
    import torch

    prof = SimpleNamespace(events=card_trace)
    got = run.read_trace(prof, torch, "warm_blocks", [0, 1, 2])
    assert got["dit_card"] == 0 and got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(250e-6)  # card 0's: kernels and its copy
    assert {c: v["busy_s"] for c, v in got["cards"].items()} == pytest.approx(
        {0: 250e-6, 1: 80e-6, 2: 20e-6})
    assert got["by_family_s"]["conv"] == pytest.approx(100e-6)  # over all cards
    # card 0's idle gaps: 150-200 and 300-1000
    assert sorted(g for _, g in got["idle_gaps"]) == pytest.approx([50e-6, 700e-6])
    run_keys = {"profile": got}
    # 60 of the VAE cards' 100 us lie under card 0's kernels (its copy left out)
    assert run.metric_reader("vae_overlap_pct")(run_keys) == pytest.approx(60.0)
    assert run.metric_reader("device_idle_pct")(run_keys) == pytest.approx(75.0)


def test_one_card_has_no_vae_overlap_and_mfu_divides_by_the_cards():
    import torch

    one = [e for e in card_trace() if getattr(e, "device_index", 0) == 0]
    got = run.read_trace(SimpleNamespace(events=lambda: one), torch, "warm_blocks", [0])
    assert run.metric_reader("vae_overlap_pct")({"profile": got}) is None
    assert run.metric_reader("vae_overlap_pct")({"profile": None}) is None
    work = {"linear": {"bf16": 989e12, "int8": 0.0, "bytes": 0.0}}  # 1 s at the bf16 peak
    mfu = run.metric_reader("block_mfu")
    assert mfu({"warm_gaps_ms": [2000.0], "work": work}) == pytest.approx(50.0)
    assert mfu({"warm_gaps_ms": [2000.0], "work": work, "cards": 4}) == pytest.approx(12.5)
