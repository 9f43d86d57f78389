"""The window's arithmetic on synthetic stamps, the traffic's repeatability
and the roofline's count of one 1.3B warm block."""
import itertools
import json
from pathlib import Path

import pytest

from gpubench import roofline, traffic_gen
from gpubench.run import SessionRecord, window_metrics
from gpubench.traffic_gen import SessionSpec

ROOT = Path(__file__).resolve().parents[2]


def _session(index, blocks, start, block_s, stall=None):
    """A session whose block b lands its frames block_s after block b - 1
    (block 0: 6 frames, then 12), with `stall` s more before block `stall[0]`."""
    r = SessionRecord(SessionSpec(index, "p", blocks), start)
    stamps, t = [], start
    for b in range(blocks):
        t += block_s + (stall[1] if stall and stall[0] == b else 0.0)
        n = 6 if b == 0 else 12
        stamps.append((t, n, r, b))
        r.block_last[b] = t
        if r.first_frame is None:
            r.first_frame = t
    return r, stamps, t


def _window(stall=None):
    """Six 4-block sessions of 0.5 s blocks in a 10 s window; `stall` delays
    one block of sessions 1-3."""
    records, stamps, t = [], [], 0.0
    for i in range(6):
        r, st, t = _session(i, 4, t, 0.5, stall if i in (1, 2, 3) else None)
        records.append(r)
        stamps += st
    return window_metrics(stamps, records, 10.0, 10.0)


def test_a_stall_inside_the_window_moves_fps_and_the_gap_tail():
    base, gaps, frames, ttff, failed = _window()
    assert failed == 0 and len(ttff) == 6
    assert frames == 5 * (6 + 3 * 12)  # sessions 0-4 end by 10 s, session 5 after
    assert base["block_gap_ms_p90"]["value"] == pytest.approx(500.0)
    stalled = _window(stall=(2, 1.5))[0]
    assert stalled["fps"]["value"] < base["fps"]["value"]
    assert stalled["block_gap_ms_p90"]["value"] > base["block_gap_ms_p90"]["value"]
    assert stalled["ttff_ms_p50"]["value"] == pytest.approx(base["ttff_ms_p50"]["value"])


def test_frames_after_the_close_do_not_count():
    metrics, gaps, frames, _, _ = _window(stall=(2, 1.5))
    # 3 s of stalls: sessions 0-2 end by 9 s, session 3's blocks 0 and 1
    # land at 9.5 and 10.0 s, the rest after the close
    assert frames == 3 * 42 + 6 + 12
    assert metrics["fps"]["value"] == pytest.approx(frames / 10.0)
    assert all(g > 0 for _, _, g in gaps) and len(gaps) == 3 * 3 + 1


@pytest.mark.parametrize("name", ["stream"])
def test_traffic_repeats_from_one_seed_and_every_seed_offers_the_same_work(name):
    mix = traffic_gen.load(name)
    take = lambda seed: list(itertools.islice(traffic_gen.sessions(mix, seed), 24))  # noqa: E731
    a, b, c = take(2**31 + 7), take(2**31 + 7), take(5)
    assert a == b
    assert [s.num_blocks for s in a] == [s.num_blocks for s in c]  # the same work
    assert [s.prompt for s in a] != [s.prompt for s in c]
    deck = traffic_gen.deck(mix)
    assert sorted(s.num_blocks for s in a[:len(deck)]) == deck
    assert all(mix["prompt_words"][0] <= len(s.prompt.split()) <= mix["prompt_words"][1]
               for s in a)


def test_roofline_counts_one_13b_warm_block_by_hand():
    cfg = json.loads((ROOT / "gpubench/configs/t2v-1.3b-int8.json").read_text())
    work = roofline.warm_block_work(cfg)
    d, f, layers, n = 1536, 8960, 30, 3 * 30 * 52  # 3 latents of 30 x 52 patches
    forwards = 5  # the context prefill and 4 denoise steps
    linear_int8 = forwards * layers * 2 * n * (3 * d * d + 3 * d * d + 2 * d * f)
    assert n == 4680 and work["linear"]["int8"] == linear_int8
    pairs = n * n + 4 * n * (2 * n) + 5 * n * 512
    assert work["attention"]["bf16"] == 4 * pairs * d * layers
    assert work["attention"]["int8"] == 0
    # the decoder's top stage: 3 residual blocks of two 3x3x3 convs, 96 -> 96,
    # over 4 frames of 480 x 832, a latent
    top = 3 * 2 * 2 * 4 * 480 * 832 * 96 * 27 * 96
    assert work["conv"]["int8"] > 3 * top
    assert roofline.least_time_s(work["attention"]) == pytest.approx(
        4 * pairs * d * layers / 989e12)


def test_family_table():
    assert roofline.family("attention_kernel<1, 0>") == "attention"
    assert roofline.family("int8_linear_kernel<128>") == "linear"
    assert roofline.family("sm90_xmma_gemm_bf16bf16_bf16f32") == "linear"
    assert roofline.family("conv_kernel<3, 1>") == "conv"
    assert roofline.family("cudnn::fprop_kernel") == "conv"
    assert roofline.family("Memcpy DtoH (Device -> Pageable)") == "copy"
    assert roofline.family("vectorized_elementwise_kernel") == "other"
