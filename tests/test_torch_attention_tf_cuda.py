"""Teacher forcing's mode of the attention kernels (csrc/attention_sm90.cu
and csrc/attention_bwd_sm90.cu, mode 2: csrc/attention_mask.cuh) against
their plain PyTorch versions, on a card (marked `cuda`; skips on a host
without one). This file imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_tf_cuda.py

The forward is held with `hopper_attention.agreement` against the plain
forward of the function the kernel computes (`attention_forward_plain` on q
prescaled by bf16(scale * log2 e), at scale 1 / log2 e: with 48 live keys a
row the raw-scale plain version is 0.32% of softmax scale apart, which shows
elementwise), and its LSE against that plain LSE within 2e-3; dq, dk and dv at `grad_atol` against
`kernel_backward_plain` under the mode-2 `Mask`, two launches bit-equal.
Shapes: blocks of 48 tokens (under one key tile), of 200 (a query tile
straddles L = 600 and the block ends), and of 384 tokens in 3 blocks.
Planted faults must fail: a noisy block that sees its own clean block, the
noisy range 16 keys short, the clean range dropped for blocks j >= 1, and
(backward) the dK/dV pass skipping the later noisy queries of a clean key.
The route `teacher_forcing_attention` is held as the kernel launch is; under
autograd it counts one `teacher_forcing` and one `teacher_forcing_bwd`
launch a call, runs no plain version, and its gradients are held against
`kernel_backward_plain`.
"""
import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.ops import hopper_attention as hk

SCALE = 128 ** -0.5
# (half length L, block tokens B)
CASES = [(96, 48), (600, 200), (1152, 384)]


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _inputs(dev, n_tokens, seed=0, heads=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, n_tokens, heads, 128)).astype(np.float32))
            .to(dev, torch.bfloat16) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("half,block", CASES)
def test_forward_kernel_matches_plain_on_gpu(half, block):
    dev = _device_or_skip()
    q, k, v, _ = _inputs(dev, 2 * half)
    mask = hk.Mask.teacher_forcing(half, block)
    want, lse_plain = hk.attention_forward_plain(hk.prescale(q, SCALE), k, v, mask,
                                                 1.0 / hk.LOG2E)
    out, lse = hk._launch_sm90(q, k, v, SCALE, None, *mask.kernel_args(), with_lse=True)
    res = hk.agreement(out, want)
    assert res["within_tol"], res
    assert (lse - lse_plain).abs().max().item() < 2e-3
    routed = hk.agreement(hk.teacher_forcing_attention(q, k, v, half, block, SCALE), want)
    assert routed["within_tol"], routed
    for fault in (hk.FAULT_TF_LEAK, hk.FAULT_TF_SHORT, hk.FAULT_TF_DROP_CLEAN):
        bad = hk._launch_sm90(q, k, v, SCALE, None, *mask.kernel_args(), fault=fault)
        assert not hk.agreement(bad, want)["within_tol"], fault


@pytest.mark.cuda
@pytest.mark.parametrize("half,block", CASES)
def test_backward_kernel_matches_plain_on_gpu(half, block):
    dev = _device_or_skip()
    q, k, v, do = _inputs(dev, 2 * half, seed=1)
    mask = hk.Mask.teacher_forcing(half, block)
    out, lse = hk._launch_sm90(q, k, v, SCALE, None, *mask.kernel_args(), with_lse=True)
    want = hk.kernel_backward_plain(q, k, v, out, do, SCALE, mask)
    got = hk.attention_backward(q, k, v, out, do, lse, SCALE, mask)
    again = hk.attention_backward(q, k, v, out, do, lse, SCALE, mask)
    torch.cuda.synchronize()
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        res = hk.agreement(g, w, hk.grad_atol(w))
        assert res["within_tol"], (name, res)
        assert torch.equal(g, g2), (name, "two launches differ")
    for fault in (hk.FAULT_TF_LEAK, hk.FAULT_TF_SHORT, hk.FAULT_TF_DROP_CLEAN,
                  hk.FAULT_TF_SKIP_NOISY_Q):
        bad = hk.attention_backward(q, k, v, out, do, lse, SCALE, mask, fault=fault)
        assert any(not hk.agreement(g, w, hk.grad_atol(w))["within_tol"]
                   for g, w in zip(bad, want)), fault


@pytest.mark.cuda
def test_autograd_route_counts_its_kernels_on_gpu():
    dev = _device_or_skip()
    q, k, v, do = _inputs(dev, 2 * 600, seed=2)
    hk.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    hk.teacher_forcing_attention(*leaves, 600, 200).backward(do)
    assert hk.LAUNCHES["teacher_forcing"] == 1 and hk.LAUNCHES["teacher_forcing_bwd"] == 1
    assert not any(hk.PLAIN_ON_CUDA.values())
    mask = hk.Mask.teacher_forcing(600, 200)
    out = hk._launch_sm90(q, k, v, SCALE, None, *mask.kernel_args())
    want = hk.kernel_backward_plain(q, k, v, out, do, SCALE, mask)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        res = hk.agreement(t.grad, w, hk.grad_atol(w))
        assert res["within_tol"], (name, res)
    with torch.no_grad():
        plain_free = hk.teacher_forcing_attention(q, k, v, 600, 200)
    assert hk.LAUNCHES["teacher_forcing"] == 2
    assert torch.isfinite(plain_free.float()).all()
    for t in leaves:
        assert torch.isfinite(t.grad.float()).all()
