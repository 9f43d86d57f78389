"""The attention backward kernel (csrc/attention_bwd_sm90.cu) and the
forward's LSE against their plain PyTorch versions, on a card (marked
`cuda`; skips on a host without one). This file imports no JAX, so it runs
on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bwd_cuda.py

dq, dk and dv are held with `hopper_attention.agreement` at `grad_atol`
(2^-7 of the largest element) and relative Frobenius 1e-2, on bf16 inputs,
against `kernel_backward_plain` (the plain backward of the function the
kernels compute, q prescaled by bf16(scale * log2 e), on the plain
forward's own LSE): the window with lo > 0 and a ragged hi, unmasked
cross-attention, block-causal with and without a local window and a ragged
last block, block-causal with Lq % 4 != 0 (the stats rows the kernel pads
for TMA), and large-norm windows (q and k at norm 1.5: the static max;
at 3.0: past it, the in-launch running-max fallback), the first also with
near-parallel keys k = [q; 0.97 q], where dq is held at
`near_parallel_dq_agreement` (bf16's own error there); two launches on the
same inputs must be bit-equal in dq, dk and dv; the autograd path (`KernelAttention`) counts one
backward launch a call and gives the same dq when k and v need no gradient
(the dQ pass alone). The forward's LSE (the static max and the running
max) must match the plain LSE of the prescaled q within 2e-3. Planted
faults must fail: the D term dropped, the window's hi 16 short (unit
norm), and a backward at a softmax scale 1% off the forward's (large norm).
"""
import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk

SCALE = 128 ** -0.5
# (name, mask, lq, lk, norm of q and k)
CASES = [
    ("window", hk.Mask.window(100, 650), 200, 700, 1.0),
    ("cross", hk.Mask.window(0, 512), 130, 512, 1.0),
    ("block_causal", hk.Mask.block_causal(300, 128), 300, 300, 1.0),
    ("block_causal_local", hk.Mask.block_causal(300, 64, 128), 300, 300, 1.0),
    ("block_causal_lq_mod4", hk.Mask.block_causal(322, 96), 322, 322, 1.0),
    ("large_norm_static", hk.Mask.window(0, 400), 200, 400, 1.5),
    ("large_norm_fallback", hk.Mask.window(0, 400), 200, 400, 3.0),
    ("near_parallel_static", hk.Mask.window(0, 400), 200, 400, 1.5),
]


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _inputs(dev, lq, lk, seed=0, n=2, norm=1.0, near_parallel=False):
    """q, k (times `norm`; or [q; 0.97 q] with `near_parallel`), v, dO."""
    rng = np.random.default_rng(seed)
    t = lambda shape, s=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * s).astype(np.float32)).to(dev, torch.bfloat16)
    q, k = t((1, lq, n, 128), norm), t((1, lk, n, 128), norm)
    if near_parallel:
        k = torch.cat([q, (q.float() * 0.97).to(torch.bfloat16)], 1)
    return q, k, t((1, lk, n, 128)), t((1, lq, n, 128))


def _lse_plain(q, k, v, mask):
    """The plain LSE of the function the kernels compute (natural log)."""
    return hk.attention_forward_plain(hk.prescale(q, SCALE), k, v, mask, 1.0 / hk.LOG2E)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name,mask,lq,lk,norm", CASES, ids=[c[0] for c in CASES])
def test_backward_kernel_matches_plain_on_gpu(name, mask, lq, lk, norm):
    dev = _device_or_skip()
    near_parallel = name.startswith("near_parallel")
    q, k, v, do = _inputs(dev, lq, lk, norm=norm, near_parallel=near_parallel)
    maxima = None
    if norm != 1.0:  # the static max below the limit, the fallback above it
        maxima = hk.logit_bound_maxima(q, k, SCALE)
        bound = float(hk.logit_bound_from_maxima(maxima)[0])
        assert (bound < hk.STATIC_MAX_LIMIT) == name.endswith("static"), (name, bound)
    out, lse = hk._launch_sm90(q, k, v, SCALE, maxima, *mask.kernel_args(), with_lse=True)
    assert (lse - _lse_plain(q, k, v, mask)).abs().max().item() < 2e-3, name
    got = hk.attention_backward(q, k, v, out, do, lse, SCALE, mask)
    want = hk.kernel_backward_plain(q, k, v, out, do, SCALE, mask)
    again = hk.attention_backward(q, k, v, out, do, lse, SCALE, mask)
    torch.cuda.synchronize()

    def check(gname, g, w):
        if near_parallel and gname == "dq":
            return hk.near_parallel_dq_agreement(g, w)
        return hk.agreement(g, w, hk.grad_atol(w))

    for gname, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        res = check(gname, g, w)
        assert res["within_tol"], (name, gname, res)
        assert torch.equal(g, g2), (name, gname, "two launches differ")
    faults = {"drop_D": lambda: hk.attention_backward(q, k, v, out, do, lse, SCALE, mask,
                                                      fault=hk.FAULT_DROP_D)}
    if mask.mode == 0 and norm == 1.0:
        faults["hi-16"] = lambda: hk.attention_backward(
            q, k, v, out, do, lse, SCALE, hk.Mask.window(mask.lo, mask.hi - 16))
    if norm != 1.0:
        faults["scale-1%"] = lambda: hk.attention_backward(q, k, v, out, do, lse,
                                                           SCALE * 0.99, mask)
    for fault, fn in faults.items():
        bad = fn()
        caught = [not check(gname, g, w)["within_tol"]
                  for gname, g, w in zip(("dq", "dk", "dv"), bad, want)]
        assert any(caught), (name, fault)


@pytest.mark.cuda
def test_static_max_lse_and_autograd_path_on_gpu():
    dev = _device_or_skip()
    q, k, v, do = _inputs(dev, 260, 600, seed=3)
    mask = hk.Mask.window(0, 600)
    maxima = hk.logit_bound_maxima(q, k, SCALE)
    _, lse = hk._launch_sm90(q, k, v, SCALE, maxima, *mask.kernel_args(), with_lse=True)
    assert (lse - _lse_plain(q, k, v, mask)).abs().max().item() < 2e-3
    hk.reset_launch_counts()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = hk.window_attention(qg, kg, vg, 0, 600)
    out.backward(do)
    assert hk.LAUNCHES["window"] == 1 and hk.LAUNCHES["window_bwd"] == 1
    assert hk.PREPASS_LAUNCHES["logit_bound"] == 1
    assert hk.PLAIN_ON_CUDA == {"window": 0, "block_causal": 0}
    qd = q.clone().requires_grad_()
    hk.window_attention(qd, k, v, 0, 600).backward(do)
    assert torch.equal(qd.grad, qg.grad)
    hk.reset_launch_counts()
    qb, kb, vb = (t[:, :260].clone().requires_grad_() for t in (q, k, v))
    hk.block_causal_attention(qb, kb, vb, 128).backward(do)
    assert hk.LAUNCHES["block_causal"] == 1 and hk.LAUNCHES["block_causal_bwd"] == 1
    for t in (qb, kb, vb, qg, kg, vg):
        assert torch.isfinite(t.grad.float()).all()
