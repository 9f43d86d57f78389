"""The attention backward at near-parallel keys, on the CPU: which error is
the plain side's, and which is bf16's.

The input is the decode window's with keys [q; 0.97 q] at large norm (q and
k at 1.5 and 3.0 times unit normal, head dim 128): each query row's two top
keys are itself and 0.97 itself, the softmax puts nearly all its weight on
them, and since sum_k dS = 0 on a row, their dS nearly cancel: dQ = scale
sum_k dS k is ~0.03 of its two largest terms. The output O is stored in
bf16, so D = rowsum(dO * O) misses sum_k P dP by O's rounding, the two dS
differ in magnitude by a fraction of a bf16 ulp, and their roundings to
bf16 (before the dQ product, as the backward kernel and FlashAttention-2,
torch SDPA's flash backward, both round dS) no longer cancel: dQ moves by
~30x bf16's 2^-9.

  * `attention_backward_plain` in f32 is held against `jax.vjp` of
    `ops/attention.py::xla_attention` in f32 on that input, and both against
    the f64 gradient, so the plain side of the card's check is right there.
    dk and dv agree within 1e-5 (relative Frobenius). dq is the cancelling
    sum: the f32 rounding of scores of up to ~100 nats (norm 3) moves P by
    ~1e-5, and the cancellation amplifies that ~30x, so the plain dq lies
    1.9e-5 (norm 1.5) and 1.0e-4 (norm 3) from the f64 gradient, JAX's
    5.9e-6 and 4.0e-5 (read here): bar 3e-4, 200x under bf16's error.
  * The dQ error that rounding dS to bf16 alone gives there (everything
    else in f64, O rounded to bf16 as stored): relative Frobenius 7.1e-2 at
    norm 1.5 and 6.9e-2 at 3.0 (read here; 5.3e-2 - 6.9e-2 on three other
    seeds), against 1.4e-3 - 1.7e-3 on random large-norm keys. dK and dV
    take the same roundings without the cancellation and stay under 2e-3.
  * The card's dq bar for the near-parallel case
    (`hopper_attention.NEAR_PARALLEL_DQ_REL_FRO`, set from SDPA flash's
    measured error, chip_smoke.py) is no tighter than that rounding alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.ops import attention as jattn
from realtime_video_tpu_torch.ops import hopper_attention as hk

B, LQ, N, D = 1, 48, 2, 128
SCALE = D ** -0.5


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(norm, near_parallel=True, seed=0):
    """q, k, v, dO in f32: k = [q; 0.97 q] (or random at the same norm)."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, LQ, N, D)) * norm).astype(np.float32)
    if near_parallel:
        k = np.concatenate([q, np.float32(0.97) * q], axis=1)
    else:
        k = (rng.normal(size=(B, 2 * LQ, N, D)) * norm).astype(np.float32)
    v = rng.normal(size=(B, 2 * LQ, N, D)).astype(np.float32)
    do = rng.normal(size=(B, LQ, N, D)).astype(np.float32)
    return q, k, v, do


def _grads_bf16_ds(q, k, v, do):
    """(dq, dk, dv) in f64, exact, and with dS (and P for dV) rounded to bf16
    before the products, as a bf16 flash backward rounds them."""
    qd, kd, vd, dod = (torch.from_numpy(a).double() for a in (q, k, v, do))
    s = torch.einsum("bqnd,bknd->bnqk", qd, kd) * SCALE
    p = torch.softmax(s, -1)
    o = torch.einsum("bnqk,bknd->bqnd", p, vd).to(torch.bfloat16).double()  # the output as stored
    dp = torch.einsum("bqnd,bknd->bnqk", dod, vd)
    delta = (dod * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    bf = lambda x: x.to(torch.bfloat16).double()  # noqa: E731
    out = {}
    for name, dsx, px in (("exact", ds, p), ("bf16", bf(ds), bf(p))):
        out[name] = (torch.einsum("bnqk,bknd->bqnd", dsx, kd) * SCALE,
                     torch.einsum("bnqk,bqnd->bknd", dsx, qd) * SCALE,
                     torch.einsum("bnqk,bqnd->bknd", px, dod))
    return out


@pytest.mark.parametrize("norm", [1.5, 3.0], ids=["norm1.5", "norm3"])
def test_plain_backward_matches_jax_at_near_parallel_keys(norm):
    q, k, v, do = _inputs(norm)
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.xla_attention(a, b, c),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    mask = hk.Mask.window(0, 2 * LQ)
    out, lse = hk.attention_forward_plain(qt, kt, vt, mask, SCALE)
    got = hk.attention_backward_plain(qt, kt, vt, out, dot, lse, SCALE, mask)
    qd, kd, vd = (torch.from_numpy(a).double().requires_grad_() for a in (q, k, v))
    p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", qd, kd) * SCALE, -1)
    exact = torch.autograd.grad(torch.einsum("bnqk,bknd->bqnd", p, vd), (qd, kd, vd),
                                torch.from_numpy(do).double())
    assert rel_fro(out.numpy(), np.asarray(out_j)) < 1e-5
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
        bar = 3e-4 if name == "dq" else 1e-5
        assert rel_fro(g.numpy(), w) < bar, (name, rel_fro(g.numpy(), w))
        for side in (g.numpy(), w):
            assert rel_fro(side, x.numpy()) < (bar if name == "dq" else 3e-5), name


@pytest.mark.parametrize("norm", [1.5, 3.0], ids=["norm1.5", "norm3"])
def test_bf16_ds_alone_moves_dq_at_near_parallel_keys(norm):
    g = _grads_bf16_ds(*_inputs(norm))
    dq_err = rel_fro(g["bf16"][0], g["exact"][0])
    assert 4e-2 < dq_err < 1e-1, dq_err
    assert dq_err < hk.NEAR_PARALLEL_DQ_REL_FRO
    for name, i in (("dk", 1), ("dv", 2)):
        err = rel_fro(g["bf16"][i], g["exact"][i])
        assert err < 2e-3, (name, err)
    # the cancellation is what amplifies it: random keys at the same norm
    r = _grads_bf16_ds(*_inputs(norm, near_parallel=False))
    assert rel_fro(r["bf16"][0], r["exact"][0]) < 2e-3
