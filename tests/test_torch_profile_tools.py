"""The block profiler's bookkeeping (it runs on a GPU; these parts do not):
the busy time of overlapping device intervals, the kernel buckets, the
live-pair FLOP counts of the attention kernel against its masks, and the
kernel-vs-plain agreement check."""
import pytest
import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.tools import profile_block as pb


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),          # overlap
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 0.7)], 2.0),  # unsorted, nested
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),          # touching
])
def test_union_length(intervals, want):
    assert pb.union_length(intervals) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("void (anonymous namespace)::attention_kernel<128>(__nv_bfloat16 const*)", "attention_kernel"),
    ("void (anonymous namespace)::attention_kernel<128, true, false>(void const*)",
     "attention_kernel"),
    ("void (anonymous namespace)::attn_int8_quantize_rows<128>(__nv_bfloat16 const*)",
     "attention_int8_prepass"),
    ("void (anonymous namespace)::attn_int8_segment_mean<128>(__nv_bfloat16 const*)",
     "attention_int8_prepass"),
    ("Memcpy DtoH (Device -> Pageable)", "copy/memset"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16>", "conv"),
    ("nvjet_tst_192x144_64x5_2x1_v_bz_coopB_NNT", "gemm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::mul>", "elementwise/other"),
    ("(anonymous namespace)::int8_linear_kernel(__nv_bfloat16 const*, signed char const*)",
     "int8_linear_kernel"),
    ("void (anonymous namespace)::conv_kernel<true, 3>(void const*, void const*)",
     "conv3x3_kernel"),
])
def test_category(name, want):
    assert pb.category(name) == want


def test_phase_timer_passes_through_when_disabled():
    timer = pb.PhaseTimer()
    assert timer.wrap("x", lambda a, b=1: a + b)(2, b=3) == 5
    assert timer.events == []


@pytest.mark.parametrize("length, block_tokens, local_window", [
    (9360, 4680, None), (448, 192, None), (448, 192, 128), (100, 30, 10), (100, 30, 45)])
def test_block_causal_flops_counts_the_mask(length, block_tokens, local_window):
    mask = hk.block_causal_mask(length, length, block_tokens, length, local_window, "cpu")
    assert hk.block_causal_flops(length, block_tokens, 3, 8, local_window) == \
        4 * 3 * 8 * int(mask.sum())


def test_window_flops_counts_live_columns():
    assert hk.window_flops(4680, 1560, 9360, 12, 128) == 4 * 12 * 128 * 4680 * 7800
    assert hk.window_flops(10, 5, 5, 1, 1) == 0


def test_agreement_passes_rounding_and_catches_dropped_columns():
    """On the CPU with the plain version: the plain output moved by about one
    bf16 ulp passes; the same window missing 16 of its 940 columns fails."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 64, 2, 128), generator=g).to(torch.bfloat16),
               torch.randn((1, 1040, 2, 128), generator=g).to(torch.bfloat16),
               torch.randn((1, 1040, 2, 128), generator=g).to(torch.bfloat16))
    q = hk.prescale(q, 128 ** -0.5)
    inv = 1.0 / hk.LOG2E
    want = hk.window_attention_plain(q, k, v, 100, 1040, scale=inv)
    nudged = (want.float() * (1 + 2 ** -8)).to(torch.bfloat16)
    assert hk.agreement(nudged, want)["within_tol"]
    dropped = hk.window_attention_plain(q, k, v, 100, 1024, scale=inv)
    res = hk.agreement(dropped, want)
    assert not res["within_tol"] and res["rel_fro_err"] > hk.REL_FRO


@pytest.mark.parametrize("flags, stem", [
    ({}, "profile_block_t2v-1.3B_int8"),
    ({"taehv": True}, "profile_block_t2v-1.3B_int8_taehv"),
    ({"int8_qk": True, "webcam": True, "umt5": True, "taehv": True},
     "profile_block_t2v-1.3B_int8_int8qk_webcam_umt5_taehv"),
])
def test_report_stem(flags, stem):
    assert pb.report_stem("t2v-1.3B", "int8", **flags) == stem


def test_taehv_decode_bound_at_832x480():
    """One block (3 latents of 60 x 104 -> 12 frames of 480 x 832): about
    0.81 T MACs, so its bf16 operations (1.62 TFLOP) bound it at ~1.64 ms,
    above its bytes' time."""
    from realtime_video_tpu_torch.models import taehv

    got = pb.taehv_decode_bound(3, 60, 104)
    macs, io_bytes = taehv.decode_work(3, 60, 104)
    assert got["flop"] == 2 * macs and got["bytes"] == io_bytes
    assert 0.80e12 < macs < 0.83e12
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(2 * macs / 989e12 * 1e3)
    assert io_bytes / 3.35e12 * 1e3 < got["bound_ms"]


def test_teacher_categories_split_self_and_cross_attention(monkeypatch):
    """A tiny train-mode forward on the CPU calls the attention self, cross,
    self, cross, ... (the order `teacher_categories` relies on); device
    events launched in that order are bucketed by it."""
    from types import SimpleNamespace

    from realtime_video_tpu_torch.config import WanModelConfig
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion

    cfg = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=3)
    gen = WanDiffusion(cfg=cfg, device="cpu", dtype=torch.float32, seed=0)
    calls, window = [], hk.window_attention
    monkeypatch.setattr(hk, "window_attention",
                        lambda q, k, *a, **kw: calls.append(k.shape[1]) or window(q, k, *a, **kw))
    g = torch.Generator().manual_seed(0)
    cross = gen.compute_crossattn_cache(torch.randn((1, 7, cfg.text_dim), generator=g))
    x = torch.randn((1, 2, 16, 4, 6), generator=g)
    flow, _, kv = gen.forward(x, cross, torch.full((1, 2), 500.0), mode="train")
    assert kv is None and flow.shape == x.shape
    assert calls == [2 * 6, 7] * cfg.num_layers  # self over 12 tokens, cross over 7

    def ev(name, start, ms):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start,
                                                                    end=start + ms * 1e3))

    names = {"self": "(anonymous namespace)::attention_kernel<128>(void const*)",
             "bound": "(anonymous namespace)::attn_logit_bound_kernel(void const*)"}
    events, clock = [], 0.0
    for layer in range(cfg.num_layers):
        for side, ms in (("self", 4.0), ("cross", 0.5)):
            events += [ev(names["bound"], clock, 0.1 if side == "self" else 0.01),
                       ev(names["self"], clock + 200, ms)]
            clock += 1000
        events += [ev("nvjet_tst_192x144_64x5_2x1_v_bz_coopB_NNT", clock, 1.0),
                   ev("void at::native::vectorized_elementwise_kernel<4>", clock + 300, 2.0)]
        clock += 1000
    got = pb.teacher_categories(events[::-1])  # any order: sorted by start
    assert got == pytest.approx({"self_attention_kernel": 12.0, "cross_attention_kernel": 1.5,
                                 "self_attention_bound_prepass": 0.3,
                                 "cross_attention_bound_prepass": 0.03, "gemm": 3.0,
                                 "elementwise/other": 6.0})
