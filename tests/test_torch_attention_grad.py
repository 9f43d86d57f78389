"""The attention gradient on the CPU: `KernelAttention` (the autograd
Function that the port's attention entry points take when a gradient is
needed) and `attention_backward_plain`, the backward kernel's plain version,
against `jax.vjp` of the JAX package's XLA attention, the gradient its
trainer takes (its Pallas kernels cannot be differentiated). Same seeded
numpy q, k, v and output cotangent on both sides, f32, relative Frobenius
1e-5 on the output and on dq, dk and dv:
  * `xla_attention` unmasked and through `decode_attention`'s window;
  * `block_causal_attention` with and without a local window;
  * fully masked rows (a dense mask with empty rows): the dense softmax is
    uniform there, and so is the plain backward's P.
Also: the int8 and skew routes refuse a gradient instead of taking the bf16
one; `attention_backward_plain` fed the plain forward's LSE gives the same
gradient as autograd through the dense plain forward; and
`kernel_backward_plain`, the backward kernel's reference, is the gradient
of the function the kernels compute (their bf16-rounded softmax scale), in
f32 and on large-norm bf16 inputs under the static max and its fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.ops import attention as jattn
from realtime_video_tpu_torch.ops import attention as attn_ops
from realtime_video_tpu_torch.ops import hopper_attention as hk

REL = 1e-5
B, N, D = 2, 3, 16


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs(seed, lq, lk, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, lq, N, D)) * scale).astype(np.float32)
    k = (rng.normal(size=(B, lk, N, D)) * scale).astype(np.float32)
    v = rng.normal(size=(B, lk, N, D)).astype(np.float32)
    do = rng.normal(size=(B, lq, N, D)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out), *map(np.asarray, vjp(jnp.asarray(do))))


def _torch_grad(fn, q, k, v, do):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(qt, kt, vt)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def _check(got, want):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        assert rel_fro(g, w) < REL, (name, rel_fro(g, w))


@pytest.mark.parametrize("lq,lk,lo,hi,scale", [
    (24, 40, 0, 40, 1.0),   # unmasked (cross-attention)
    (24, 40, 7, 33, 1.0),   # a decode window
    (24, 40, 0, 24, 3.0),   # a window ending early, sharp softmax
])
def test_window_gradient_matches_jax(lq, lk, lo, hi, scale):
    q, k, v, do = _inputs(lq + lo + hi, lq, lk, scale)
    if lo == 0 and hi == lk:
        want = _jax_vjp(lambda a, b, c: jattn.xla_attention(a, b, c), q, k, v, do)
        got = _torch_grad(lambda a, b, c: attn_ops.attention(a, b, c), q, k, v, do)
    else:
        want = _jax_vjp(lambda a, b, c: jattn.decode_attention(a, b, c, lo, hi), q, k, v, do)
        got = _torch_grad(lambda a, b, c: attn_ops.decode_attention(a, b, c, lo, hi),
                          q, k, v, do)
    _check(got, want)


@pytest.mark.parametrize("block_tokens,local_window", [(8, None), (8, 16), (10, None)])
def test_block_causal_gradient_matches_jax(block_tokens, local_window):
    q, k, v, do = _inputs(block_tokens, 36, 36)
    want = _jax_vjp(lambda a, b, c: jattn.block_causal_attention(a, b, c, block_tokens,
                                                                 local_window), q, k, v, do)
    got = _torch_grad(lambda a, b, c: attn_ops.block_causal_attention(a, b, c, block_tokens,
                                                                      local_window), q, k, v, do)
    _check(got, want)


def test_fully_masked_rows_match_jax():
    """Rows 0-3 see no key: the dense softmax spreads them evenly (finite,
    NEG_INF = -1e30), dS is 0 there and dv takes 1/Lk of their dO."""
    lq, lk = 12, 20
    q, k, v, do = _inputs(5, lq, lk)
    mask = np.ones((lq, lk), bool)
    mask[:4] = False
    mask[6, 10:] = False
    jmask = jnp.asarray(mask)[None, None]
    want = _jax_vjp(lambda a, b, c: jattn.xla_attention(a, b, c, mask=jmask), q, k, v, do)
    # the plain backward under the same dense mask: autograd through the plain forward
    got = _torch_grad(lambda a, b, c: attn_ops.attention(
        a, b, c, mask=torch.from_numpy(mask)[None, None]), q, k, v, do)
    _check(got, want)
    # and the recompute formulas, fed the plain forward's LSE (a window that
    # keeps no key masks every row)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    empty = hk.Mask.window(5, 5)
    out, lse = hk.attention_forward_plain(qt, kt, vt, empty, D ** -0.5)
    grads = hk.attention_backward_plain(qt, kt, vt, out, dot, lse, D ** -0.5, empty)
    want = _jax_vjp(lambda a, b, c: jattn.decode_attention(a, b, c, 5, 5), q, k, v, do)
    _check((out.numpy(), *(g.numpy() for g in grads)), want)
    assert not grads[0].any() and not grads[1].any()


@pytest.mark.parametrize("mask", [hk.Mask.window(3, 30), hk.Mask.block_causal(30, 7, 14)],
                         ids=["window", "block_causal_local"])
def test_backward_plain_equals_autograd_of_the_plain_forward(mask):
    q, k, v, do = _inputs(9, 30, 30)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    valid = mask.dense(30, 30, "cpu")
    ref = hk._masked_softmax_attention(qt, kt, vt, valid, D ** -0.5)
    want = torch.autograd.grad(ref, (qt, kt, vt), torch.from_numpy(do))
    out, lse = hk.attention_forward_plain(qt.detach(), kt.detach(), vt.detach(), mask, D ** -0.5)
    got = hk.attention_backward_plain(qt.detach(), kt.detach(), vt.detach(), out,
                                      torch.from_numpy(do), lse, D ** -0.5, mask,
                                      heads_per_chunk=2)
    assert torch.equal(out, ref.detach())
    for g, w in zip(got, want):
        assert rel_fro(g.numpy(), w.numpy()) < REL


@pytest.mark.parametrize("mask", [hk.Mask.window(3, 30), hk.Mask.block_causal(30, 7, 14)],
                         ids=["window", "block_causal_local"])
def test_kernel_backward_plain_is_the_gradient_in_f32(mask):
    """In f32 the prescale is exact, so the backward kernel's reference is
    the gradient of the dense plain forward at the exact scale."""
    q, k, v, do = _inputs(10, 30, 30)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref = hk._masked_softmax_attention(qt, kt, vt, mask.dense(30, 30, "cpu"), D ** -0.5)
    want = torch.autograd.grad(ref, (qt, kt, vt), torch.from_numpy(do))
    got = hk.kernel_backward_plain(qt.detach(), kt.detach(), vt.detach(), ref.detach(),
                                   torch.from_numpy(do), D ** -0.5, mask)
    for g, w in zip(got, want):
        assert rel_fro(g.numpy(), w.numpy()) < REL


@pytest.mark.parametrize("norm", [1.5, 3.0], ids=["static_max", "fallback"])
def test_kernel_backward_plain_differentiates_the_kernels_scale(norm):
    """bf16 q and k at head dim 128 and large norm, as the forward's
    large-norm case: at 1.5 the logit bound stays under STATIC_MAX_LIMIT
    (the static max) with row maxima of 7-15 log2 units, at 3.0 it passes
    it (the fallback) with maxima of 30-59. The kernels score bf16(q c) k^T
    with c = bf16(scale log2 e), 0.32% above scale log2 e;
    `kernel_backward_plain` is the gradient of that function (autograd
    through its dense f32 form, the prescale's rounding passed straight
    through) within the bf16 rounding of its outputs (2.4e-3 read). The
    exact-scale backward fed that function's LSE is not: its P sums to less
    than 1, and its gradients are 2.3-2.5% (norm 1.5) and 8-9% (norm 3) off,
    past the kernel checks' relative Frobenius bound, 1e-2."""
    rng = np.random.default_rng(11)
    lq, lk, n, d = 64, 512, 2, 128
    scale = d ** -0.5

    def t(shape, s=1.0):
        return torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))

    q, k = t((1, lq, n, d), norm).bfloat16(), t((1, lk, n, d), norm).bfloat16()
    v, do = t((1, lk, n, d)).bfloat16(), t((1, lq, n, d))
    mask = hk.Mask.window(0, lk)
    bound = float(hk.logit_bound_plain(q, k, scale)[0])
    assert (bound < hk.STATIC_MAX_LIMIT) == (norm == 1.5)
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    qc = hk.prescale(q, scale).float() + (qf - qf.detach()) * hk.qscale(scale)
    out = hk._masked_softmax_attention(qc, kf, vf, mask.dense(lq, lk, "cpu"), 1.0 / hk.LOG2E)
    want = torch.autograd.grad(out, (qf, kf, vf), do)
    got = hk.kernel_backward_plain(q, k, v, out.detach(), do, scale, mask)
    for g, w in zip(got, want):
        assert rel_fro(g.float().numpy(), w.numpy()) < 5e-3
    _, lse = hk.attention_forward_plain(hk.prescale(q, scale), k, v, mask, 1.0 / hk.LOG2E)
    biased = hk.attention_backward_plain(q, k, v, out.detach(), do, lse, scale, mask)
    for g, w in zip(biased, want):
        assert rel_fro(g.float().numpy(), w.numpy()) > 2e-2


@pytest.mark.parametrize("switch,call", [
    ("INT8_QK", lambda q: hk.window_attention(q, q, q, 0, 8)),
    ("SKEW", lambda q: hk.window_attention(q, q, q, 0, 8)),
    ("SKEW2", lambda q: hk.window_attention(q, q, q, 0, 8)),
    ("INT8_QK", lambda q: hk.block_causal_attention(q, q, q, 4)),
])
def test_routes_without_a_backward_refuse_a_gradient(monkeypatch, switch, call):
    monkeypatch.setattr(hk, switch, True)
    q = torch.randn(1, 8, 2, D, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        call(q)
    with torch.no_grad():  # without a gradient the route runs as before
        assert call(q).shape == q.shape
