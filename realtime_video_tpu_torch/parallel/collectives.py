"""The collectives of the port's parallel paths, each one explicit.

GSPMD places these in the JAX package; here every one is a call in the code.

Tensor parallelism (Megatron's pair, and one more):
  * `copy_to_tp(x)`: forward the identity, backward an all-reduce. It
    stands where a replicated activation enters column-parallel linears
    (each rank's gradient of x covers its own columns only);
  * `reduce_from_tp(x)`: forward an all-reduce, backward the identity. It
    sums the partial outputs of a row-parallel linear. Its backward must
    not all-reduce: the summed output is replicated and every rank's
    gradient of it is already the whole one, so an all-reduce there (as
    `torch.distributed.nn.functional.all_reduce` does) scales it by tp;
  * `sum_over_tp(x)`: forward and backward an all-reduce. A sum over
    shards whose result each rank uses on its own shard (the q/k RMSNorm's
    sum of squares over the whole width): each rank's gradient of the sum
    is a share of the whole.
  * `all_reduce_max_(t)`: in place, no gradient (the attention's logit
    bound, an int8 linear's dynamic activation scale).
Sequence parallelism: `all_gather`, `all_to_all` (tiled on dim 0) and
`ring_exchange` (batch_isend_irecv of a ring step's K/V to the next rank
and from the previous one, left in flight).

Gloo and CUDA tensors. Ranks that share one card run over gloo, which
all-reduces CUDA tensors on the card's build (torch 2.11 + CUDA 12.8:
`gloo_takes_cuda`, probed and printed by every phase that shares a card).
A build that refuses them fails that probe; nothing stages an operand
through the host in its place.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """All-reduce `t` in place over `group`; returns it."""
    dist.all_reduce(t, op=op, group=group)
    return t


def gloo_takes_cuda(group=None, device=None) -> Tuple[bool, str]:
    """(whether gloo all-reduces a CUDA tensor, SUM and MAX, on this build;
    the error it raised otherwise). A collective: every rank calls it."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    try:
        t = torch.ones(2, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        torch.cuda.synchronize(device)
        return True, ""
    except RuntimeError as e:  # the refusal is raised before any transfer
        return False, str(e).splitlines()[0]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def sum_over_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOverTP.apply(x, group)


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise MAX over `group`, in place, outside autograd."""
    with torch.no_grad():
        return _all_reduce(t, dist.ReduceOp.MAX, group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor <- its mean over `group`, in place (the dp gradient:
    the local means summed, then divided by dp)."""
    size = dist.get_world_size(group)
    with torch.no_grad():
        for t in tensors:
            _all_reduce(t, dist.ReduceOp.SUM, group)
            t.div_(size)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in group-rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [size, ...]: slice j goes to group rank j; returns [size, ...] whose
    slice j came from group rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)  # contiguous: empty_like keeps a permuted input's strides
    dist.all_to_all_single(out, x, group=group)
    return out


def ring_exchange(tensors: Sequence[torch.Tensor],
                  group) -> Tuple[List[torch.Tensor], List[object]]:
    """Send each tensor to the next rank of the ring `group` and receive as
    many from the previous one; returns (the receive buffers, the requests),
    the transfers in flight until `wait` is called on the requests."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % size)
    prv = dist.get_global_rank(group, (me - 1) % size)
    tensors = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recvs])
    return recvs, dist.batch_isend_irecv(ops)


def wait(requests: Optional[Sequence[object]]) -> None:
    for r in requests or ():
        r.wait()
