"""The DiT norm glue's row kernels (csrc/dit_norm_sm90.cu) against their plain
twins on a card (marked `cuda`; skips on a host without one). This file
imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_dit_norm_cuda.py

Bound: the kernels make the plain chains' roundings in the same order, and
only the order of the f32 statistics' sums differs, which can move the
normalised value n (bf16) by one step, rarely. Every element must equal the
plain twin's, or the twin's chain computed from n one bf16 step up or down
(for RoPE, from either element of the pair), and 99% must be bit-equal at
these small shapes (chip_smoke.py holds 99.9% at the serving shapes); the
residual is elementwise and exact. Widths cover both launch shapes of the
models (1536, 5120), the widest the launch takes (its shared memory past
the default limit), a width that leaves lanes of the last warp idle (72),
and rows that end inside a thread block's rows and cross frame boundaries.
"""
import pytest
import torch

from realtime_video_tpu_torch.models.rope import RopeTables, rope_apply_fused
from realtime_video_tpu_torch.models.wan_dit import layer_norm, modulate
from realtime_video_tpu_torch.ops import hopper_dit_norm as dn


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _step(n, move):
    return (n.view(torch.int16) + move).view(torch.bfloat16)


def _explained(got, want, n, tail, pairs=False):
    """got equals want, or tail(n) with n moved one bf16 step (each element
    of a RoPE pair on its own), in every element; 99% bit-equal."""
    same = got.view(torch.int16) == want.view(torch.int16)
    assert float(same.float().mean()) >= 0.99
    ok = same.clone()
    parity = torch.arange(n.shape[-1], device=n.device) % 2 == 0
    for a in (-1, 0, 1):
        for c in ((-1, 0, 1) if pairs else (0,)):
            if a or c:
                move = torch.where(parity, a, c if pairs else a).to(torch.int16)
                ok |= got.view(torch.int16) == tail(_step(n, move)).view(torch.int16)
    assert bool(ok.all()), int((~ok).sum())


# (batch, frames, tokens per frame, width)
SHAPES = [(1, 3, 7, 72), (2, 3, 5, 1536), (1, 3, 11, 5120), (1, 2, 5, dn.MAX_WIDTH)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, f, fsl, d", SHAPES)
@pytest.mark.parametrize("site", ["msa", "gated_affine", "residual_modulate", "gated_only"])
def test_add_ln_modulate_matches_plain_on_gpu(b, f, fsl, d, site):
    dev = _device_or_skip()
    g = torch.Generator(device=dev).manual_seed(d)
    L = f * fsl
    x = (torch.randn((b, L, d), generator=g, device=dev) * 3).to(torch.bfloat16)
    y = torch.randn((b, L, d), generator=g, device=dev).to(torch.bfloat16)
    em = torch.randn((b, f, 6, d), generator=g, device=dev) * 0.3
    w = torch.randn((d,), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((d,), generator=g, device=dev).to(torch.bfloat16)
    kw = {"msa": dict(shift=em[:, :, 0], scale=em[:, :, 1]),
          "gated_affine": dict(y=y, gate=em[:, :, 2], weight=w, bias=bias),
          "residual_modulate": dict(y=y, shift=em[:, :, 3], scale=em[:, :, 4]),
          "gated_only": dict(y=y, gate=em[:, :, 5], norm=False)}[site]
    launches = dn.LAUNCHES["add_ln_modulate"]
    got = dn.add_ln_modulate(x, f, **kw)
    want = dn.add_ln_modulate_plain(x, f, **kw)
    torch.cuda.synchronize()
    assert dn.LAUNCHES["add_ln_modulate"] == launches + 1
    assert torch.equal(got[0], want[0])  # the residual is elementwise: exact
    if want[1] is None:
        assert got[1] is None
        return
    n = layer_norm(want[0], eps=1e-6)
    if "shift" in kw:  # the rest of the chain from n: modulate, or the affine
        def tail(m):
            return modulate(m, f, kw["shift"], kw["scale"])
    else:
        def tail(m):
            return m * w + bias
    _explained(got[1], want[1], n, tail)


@pytest.mark.cuda
@pytest.mark.parametrize("b, f, fsl, d", SHAPES[1:])
@pytest.mark.parametrize("layout", ["qkv", "split", "q_only"])
def test_qk_norm_rope_matches_plain_on_gpu(b, f, fsl, d, layout):
    dev = _device_or_skip()
    g = torch.Generator(device=dev).manual_seed(d + 1)
    L, dh = f * fsl, 128
    if layout == "qkv":
        q, k, _ = (torch.randn((b, L, 3 * d), generator=g, device=dev) * 2).to(
            torch.bfloat16).chunk(3, dim=-1)
    else:
        q, k = ((torch.randn((b, L, d), generator=g, device=dev) * 2).to(torch.bfloat16)
                for _ in range(2))
    wq, wk = (torch.randn((d,), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    rope = None if layout == "q_only" else RopeTables.create(dh, device=dev).fused(f, 1, fsl, 2)
    k = None if layout == "q_only" else k
    got = dn.qk_norm_rope(q, k, wq, wk, rope, dh)
    want = dn.qk_norm_rope_plain(q, k, wq, wk, rope, dh)
    torch.cuda.synchronize()
    assert got[0].is_contiguous() and got[0].shape == (b, L, d // dh, dh)
    assert (got[1] is None) == (k is None)
    ones = torch.ones((d,), dtype=torch.bfloat16, device=dev)
    for x, wx, g_out, w_out in ((q, wq, got[0], want[0]), (k, wk, got[1], want[1])):
        if x is None:
            continue
        n = dn.qk_norm_rope_plain(x, None, ones, None, None, dh)[0].reshape(b, L, d)

        def tail(m, wx=wx):  # the rest of the chain from n: * w, then RoPE
            o = m * wx
            return o if rope is None else rope_apply_fused(
                o.reshape(b, L, d // dh, dh), *rope).reshape(b, L, d)

        _explained(g_out.reshape(b, L, d), w_out.reshape(b, L, d), n, tail,
                   pairs=rope is not None)
