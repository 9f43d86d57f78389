"""The kernels at the sharded shapes of the parallel paths, on a card
(marked `cuda`; skips on a host without one). This file imports no JAX, so
it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

  * the sequence-parallel ring's composition: for one query shard, K1 with
    its LSE over each key shard (`window_attention(return_lse=True)`), merged
    by `sequence.merge_partial`, against one K1 launch over all keys, under
    `hopper_attention.agreement`, the LSE within 2e-3; key shards whose last
    tile is partial included;
  * K3 on row-parallel shards (a slice along K of a K-major w_q, a column
    slice of its storage): refused as it is (`check_weight_layout`), taken
    once `hopper_int8_mm.k_major` lays it out again, and within 1 bf16 ulp
    of the plain version;
  * the logit bound's pre-pass on each tp rank's heads, MAX-reduced (the
    elementwise max over the ranks, what `collectives.all_reduce_max_`
    computes), equal to the pre-pass over all heads bit for bit.
"""
import pytest
import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm
from realtime_video_tpu_torch.parallel import sequence


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _bf16(shape, gen, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("length, heads, sp", [(2048, 2, 2), (2048, 3, 4), (4095 * 2, 2, 2),
                                               (1000, 2, 8)])
def test_ring_composition_matches_one_launch(length, heads, sp):
    dev = _device_or_skip()
    gen = torch.Generator(device=dev).manual_seed(length + sp)
    share = length // sp
    q = _bf16((1, share, heads, 128), gen, dev)
    k = _bf16((1, share * sp, heads, 128), gen, dev)
    v = _bf16((1, share * sp, heads, 128), gen, dev)
    out = lse = None
    hk.reset_launch_counts()
    for i in range(sp):
        ks = k[:, i * share:(i + 1) * share].contiguous()
        vs = v[:, i * share:(i + 1) * share].contiguous()
        o, lo = hk.window_attention(q, ks, vs, 0, share, route="window", return_lse=True)
        out, lse = sequence.merge_partial(out, lse, o, lo)
    assert hk.LAUNCHES["window"] == sp
    want, want_lse = hk.window_attention(q, k, v, 0, share * sp, route="window",
                                         return_lse=True)
    agree = hk.agreement(out.to(q.dtype), want)
    assert agree["within_tol"], agree
    assert (lse - want_lse).abs().max().item() < 2e-3
    # the launch's LSE is of the function it computes: scores bf16(q c) k^T
    # (`kernel_backward_plain`), the plain forward's on q prescaled as it rounds it
    _, plain_lse = hk.attention_forward_plain(hk.prescale(q, q.shape[-1] ** -0.5), k, v,
                                              hk.Mask.window(0, share * sp), 1.0 / hk.LOG2E)
    assert (want_lse - plain_lse).abs().max().item() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("k_total, n, tp", [(3456 * 2, 256, 2), (512, 192, 4)])
def test_k3_on_row_shards_laid_out_again(k_total, n, tp):
    dev = _device_or_skip()
    gen = torch.Generator(device=dev).manual_seed(k_total)
    w = hm.k_major(torch.randint(-127, 128, (k_total, n), generator=gen, device=dev,
                                 dtype=torch.int8))
    scale = torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-3
    step = k_total // tp
    for r in range(tp):
        raw = w[r * step:(r + 1) * step]
        with pytest.raises(ValueError, match="k_major"):
            hm.check_weight_layout(raw)
        shard = hm.k_major(raw)
        x = _bf16((1, 300, step), gen, dev)
        a = hm.dynamic_scale(x)
        got = hm.int8_linear(x, shard, scale, a)
        want = hm.int8_linear_plain(x, shard, scale, a)
        _, exp = torch.frexp(want.float())
        ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), exp - 8).clamp_min(
            2.0 ** -126)
        assert ((got.float() - want.float()).abs() / ulp).max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_max_reduced_bound_equals_unsharded_prepass(tp):
    dev = _device_or_skip()
    gen = torch.Generator(device=dev).manual_seed(tp)
    heads = 8
    # heads of different norms, so that one rank's own bound is smaller
    scales = torch.linspace(0.5, 2.0, heads, device=dev)[None, None, :, None]
    q = (torch.randn((1, 700, heads, 128), generator=gen, device=dev) * scales).to(
        torch.bfloat16)
    k = (torch.randn((1, 900, heads, 128), generator=gen, device=dev) * scales).to(
        torch.bfloat16)
    scale = 128 ** -0.5
    whole = hk.logit_bound_maxima(q, k, scale)
    n = heads // tp
    parts = [hk.logit_bound_maxima(q[:, :, r * n:(r + 1) * n].contiguous(),
                                   k[:, :, r * n:(r + 1) * n].contiguous(), scale)
             for r in range(tp)]
    reduced = torch.stack(parts).amax(0)
    assert torch.equal(reduced, whole)
    assert not torch.equal(parts[0], whole)
