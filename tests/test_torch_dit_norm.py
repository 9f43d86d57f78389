"""The DiT norm glue's row kernels (csrc/dit_norm_sm90.cu, ops/hopper_dit_norm.py)
on the CPU: what surrounds them, since the kernels run only on a card
(tests/test_torch_dit_norm_cuda.py holds them to these twins there).

  * the wrapper's plain twins equal the plain chains of models/wan_dit.py
    bit for bit in bf16: `layer_norm` -> `modulate` or the affine, `gate` +
    the residual, and `rms_norm` -> `rope.rope_apply_fused`, with rows that
    cross frame boundaries, q / k read out of a fused qkv output;
  * `dit_forward` with every norm site sent through the wrapper (its twins
    on the CPU) equals the plain forward bit for bit, in decode and prefill
    mode, with fused and split q/k/v and without norm3: the sites' wiring;
  * the dispatch predicate sends CPU, requires-grad, tp (for q/k) and
    sequence-parallel (a tensor of frame indices) calls to the plain chain,
    and counts the ones on a card in PLAIN_ON_CUDA;
  * the kernels' symbol names fall in the profile's "other" family of the
    benchmark's roofline and in the block profiler's own bucket.
"""
import dataclasses
import types

import pytest
import torch

from gpubench import roofline
from realtime_video_tpu_torch.config import WAN_CONFIGS
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.models.rope import RopeTables, rope_apply_fused
from realtime_video_tpu_torch.ops import hopper_dit_norm as dn
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.tools import profile_block as pb

BF16 = torch.bfloat16


def rand(seed, shape, scale=1.0, dtype=BF16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16), b.view(torch.int16))


# (batch, frames, tokens per frame, width, site)
LN_CASES = [
    (1, 3, 5, 16, "msa"), (2, 3, 5, 24, "msa"), (1, 1, 7, 8, "msa"),
    (2, 2, 6, 16, "gated_affine"), (1, 3, 4, 32, "gated_affine"),
    (2, 3, 5, 16, "residual_modulate"), (1, 4, 3, 24, "residual_modulate"),
    (2, 3, 5, 16, "gated_only"), (1, 2, 9, 40, "head"),
]


@pytest.mark.parametrize("b, f, fsl, d, site", LN_CASES)
def test_add_ln_modulate_twin_is_the_plain_chain(b, f, fsl, d, site):
    L = f * fsl
    x = rand(1, (b, L, d), 3.0)
    y = rand(2, (b, L, d), 2.0)
    em = rand(3, (b, f, 6 if site != "head" else 2, d), 0.5, torch.float32)
    w, bias = rand(4, (d,), 1.0), rand(5, (d,), 0.3)
    eps = 1e-6
    if site == "msa":  # the layer's first norm
        got = dn.add_ln_modulate(x, f, shift=em[:, :, 0], scale=em[:, :, 1], eps=eps)
        want = (x, tdit.modulate(tdit.layer_norm(x, eps=eps), f, em[:, :, 0], em[:, :, 1]))
    elif site == "gated_affine":  # the self-attention residual, then norm3
        got = dn.add_ln_modulate(x, f, y, em[:, :, 2], weight=w, bias=bias, eps=eps)
        t = x + tdit.gate(y, f, em[:, :, 2])
        want = (t, tdit.layer_norm(t, w, bias, eps=eps))
    elif site == "residual_modulate":  # the cross-attention residual, then the FFN's norm
        got = dn.add_ln_modulate(x, f, y, shift=em[:, :, 3], scale=em[:, :, 4], eps=eps)
        t = x + y
        want = (t, tdit.modulate(tdit.layer_norm(t, eps=eps), f, em[:, :, 3], em[:, :, 4]))
    elif site == "gated_only":  # the FFN's closing residual
        got = dn.add_ln_modulate(x, f, y, em[:, :, 5], norm=False)
        want = (x + tdit.gate(y, f, em[:, :, 5]), None)
    else:  # the head
        got = dn.add_ln_modulate(x, f, shift=em[:, :, 0], scale=em[:, :, 1], eps=eps)
        want = (x, tdit.modulate(tdit.layer_norm(x, eps=eps), f, em[:, :, 0], em[:, :, 1]))
    assert bits_equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        assert bits_equal(got[1], want[1])
    # the same site through wan_dit's dispatch (the plain chain on the CPU)
    kw = dict(y=y, g=em[:, :, 2], weight=w, bias=bias) if site == "gated_affine" else \
        dict(y=y, shift=em[:, :, 3], scale=em[:, :, 4]) if site == "residual_modulate" else \
        dict(y=y, g=em[:, :, 5], norm=False) if site == "gated_only" else \
        dict(shift=em[:, :, 0], scale=em[:, :, 1])
    site_out = tdit.norm_site(x, f, eps, **kw)
    assert bits_equal(site_out[0], want[0])
    if want[1] is not None:
        assert bits_equal(site_out[1], want[1])


# (batch, frames, tokens per frame, heads, head dim, layout, rope)
QK_CASES = [
    (1, 3, 5, 2, 8, "qkv", True), (2, 2, 4, 4, 8, "qkv", True),
    (1, 3, 5, 2, 16, "split", True), (1, 2, 6, 3, 8, "q_only", False),
    (2, 1, 7, 2, 8, "qkv", False),
]


@pytest.mark.parametrize("b, f, fsl, n, dh, layout, with_rope", QK_CASES)
def test_qk_norm_rope_twin_is_the_plain_chain(b, f, fsl, n, dh, layout, with_rope):
    L, d = f * fsl, n * dh
    grid_h = 1 if fsl % 2 else 2
    tables = RopeTables.create(dh).fused(f, grid_h, fsl // grid_h, 2) if with_rope else None
    if layout == "qkv":  # the thirds of the fused projection's output
        q, k, _ = rand(6, (b, L, 3 * d), 4.0).chunk(3, dim=-1)
        assert q.stride(1) == 3 * d
    else:
        q, k = rand(6, (b, L, d), 4.0), rand(7, (b, L, d), 4.0)
    if layout == "q_only":
        k = None
    wq, wk = rand(8, (d,), 1.0), rand(9, (d,), 1.0)
    eps = 1e-6
    got_q, got_k = dn.qk_norm_rope(q, k, wq, wk, tables, dh, eps=eps)

    def chain(x, w):
        y = tdit.rms_norm({"scale": w}, x, eps=eps).reshape(b, L, n, dh)
        return y if tables is None else rope_apply_fused(y, *tables)

    assert bits_equal(got_q, chain(q, wq))
    assert got_q.is_contiguous()
    if k is None:
        assert got_k is None
    else:
        assert bits_equal(got_k, chain(k, wk))


@pytest.fixture(scope="module")
def tiny():
    """A tiny bf16 model whose norm scales, biases, modulation and head are
    random, so that every operand of the sites matters."""
    cfg = WAN_CONFIGS["t2v-tiny"]
    g = torch.Generator().manual_seed(0)
    params = tdit.init_wan_params(cfg, g)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: perturb(v) for k, v in tree.items()}
        noise = torch.randn(tree.shape, generator=g) * 0.1
        return (tree.float() + noise).to(tree.dtype)

    params = perturb(params)
    ctx = rand(10, (1, 16, cfg.text_dim), 1.0)
    cross = tdit.compute_crossattn_cache(cfg, params, ctx)
    return cfg, params, cross


def _forward(cfg, params, cross, mode, x, start):
    fsl = (x.shape[-2] // 2) * (x.shape[-1] // 2)
    kv = kvc.init_kv_cache(cfg.num_layers, 1, 6 * fsl, cfg.num_heads, cfg.head_dim)
    t = torch.full(x.shape[:2], 500.0)
    kw = (dict(max_attention_size=6 * fsl, current_start=start) if mode == "decode"
          else dict(prefill_block_tokens=3 * fsl))
    with torch.no_grad():
        flow, kv = tdit.dit_forward(cfg, params, x, t, RopeTables.create(cfg.head_dim), cross,
                                    mode=mode, kv_cache=kv, **kw)
    return flow, kv


@pytest.mark.parametrize("mode, layout, cross_norm", [
    ("decode", "qkv", True), ("prefill", "qkv", True), ("decode", "split", True),
    ("decode", "qkv", False)])
def test_forward_through_the_sites_is_the_plain_forward(tiny, monkeypatch, mode, layout,
                                                        cross_norm):
    cfg, params, cross = tiny
    if layout == "qkv":
        params = tdit.fuse_qkv_params(params)
    if not cross_norm:
        cfg = dataclasses.replace(cfg, cross_attn_norm=False)
        params = dict(params, blocks={k: v for k, v in params["blocks"].items()
                                      if k != "norm3"})
    x = rand(11, (1, 3, cfg.in_dim, 4, 6), 1.0)
    start = 3 * 6 if mode == "decode" else 0
    want, want_kv = _forward(cfg, params, cross, mode, x, start)
    calls = []

    def always(kernel, *args, **kw):
        calls.append(kernel)
        return True

    monkeypatch.setattr(dn, "engages", always)
    got, got_kv = _forward(cfg, params, cross, mode, x, start)
    assert bits_equal(got, want)
    assert bits_equal(got_kv["k"], want_kv["k"]) and bits_equal(got_kv["v"], want_kv["v"])
    # 6 sites a layer (2 of them q/k) and the head's
    assert calls.count("add_ln_modulate") == 4 * cfg.num_layers + 1
    assert calls.count("qk_norm_rope") == 2 * cfg.num_layers


def _card(shape=(1, 6, 16), dtype=BF16, requires_grad=False):
    """A stand-in for a tensor on a card: the attributes `engages` reads."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=shape,
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("case, kernel, args, kw, want", [
    ("card_bf16", "add_ln_modulate", (_card(), _card(), None), dict(frames=3), True),
    ("card_qk", "qk_norm_rope", (_card(), _card()), dict(head_dim=8), True),
    ("cpu", "add_ln_modulate", (torch.zeros(1, 6, 16, dtype=BF16),), dict(frames=3), False),
    ("requires_grad_x", "add_ln_modulate", (_card(requires_grad=True),), dict(frames=3),
     False),
    ("requires_grad_param", "qk_norm_rope", (_card(), None, _card((16,), requires_grad=True)),
     dict(head_dim=8), False),
    ("sp_frame_indices", "add_ln_modulate", (_card(),),
     dict(frames=torch.arange(6) // 2), False),
    ("tp_qk", "qk_norm_rope", (_card(), _card()), dict(tp=object(), head_dim=8), False),
    ("f32", "add_ln_modulate", (_card(dtype=torch.float32),), dict(frames=3), False),
    ("too_wide", "add_ln_modulate", (_card((1, 6, dn.MAX_WIDTH + 8)),), dict(frames=3), False),
    ("odd_width", "add_ln_modulate", (_card((1, 6, 12)),), dict(frames=3), False),
    ("head_dim_4", "qk_norm_rope", (_card(), _card()), dict(head_dim=4), False),
])
def test_dispatch_predicate(case, kernel, args, kw, want):
    dn.reset_launch_counts()
    assert dn.engages(kernel, *args, **kw) is want
    on_card = args[0].is_cuda
    assert dn.PLAIN_ON_CUDA[kernel] == (0 if want or not on_card else 1)


def test_grad_mode_off_engages_a_trainable_tensor():
    """Under no_grad nothing builds a graph, so a parameter that would need
    a gradient does not keep the kernel off."""
    with torch.no_grad():
        assert dn.engages("add_ln_modulate", _card(requires_grad=True), frames=3)


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::dit_add_ln_modulate_kernel<4>((anonymous namespace)::LnArgs)",
    "void (anonymous namespace)::dit_add_ln_modulate_kernel<1>((anonymous namespace)::LnArgs)",
    "void (anonymous namespace)::dit_qk_norm_rope_kernel<4>((anonymous namespace)::QkArgs)",
    "void (anonymous namespace)::dit_qk_norm_rope_kernel<1>((anonymous namespace)::QkArgs)",
])
def test_kernel_names_fall_in_the_other_family(name):
    """The benchmark's rooflines bucket kernels by name: these kernels must
    charge no attention, linear or conv roofline."""
    assert roofline.family(name) == "other"
    lowered = name.lower()
    for word in ("conv", "gemm", "cutlass", "attention_kernel", "attn_int8_",
                 "int8_linear_kernel", "fprop", "cudnn", "nvjet"):
        assert word not in lowered
    assert pb.category(name) == "dit_norm_kernel"
    assert "dit_norm_kernel" in pb.CATEGORIES


@pytest.mark.parametrize("rows, d, residual, norm, want", [
    (4680, 5120, False, True, 4680 * 5120 * 4), (4680, 5120, True, True, 4680 * 5120 * 8),
    (4680, 5120, True, False, 4680 * 5120 * 6)])
def test_bytes_count_each_row_once(rows, d, residual, norm, want):
    got = dn.add_ln_modulate_bytes(rows, d, residual, norm, frames=3, per_frame=2)
    assert got == want + 2 * 3 * d * 4
    assert dn.qk_norm_rope_bytes(rows, d) == 2 * (rows * d * 4 + d * 2)
