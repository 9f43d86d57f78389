"""Sequence parallelism for the bidirectional teacher: Ulysses, ring and the
USP hybrid (port of realtime_video_tpu/parallel/sequence.py).

The reference shards the 50-step teacher's 32760-token sequence over GPUs
with xDiT USP (wan/distributed/xdit_context_parallel.py:149-184). Each rank
holds a contiguous 1/sp of the tokens (`shard_sequence`), and only the
self-attention mixes them:

  * Ulysses (`ulysses_attention`): an all-to-all turns [B, L/sp, N, D] into
    [B, L, N/sp, D] (the sequence gathered, the heads split), one K1 launch
    attends over the whole sequence on N/sp heads (its static logit bound
    MAX-reduced over the group, so it is one device's function), and a
    second all-to-all restores the token split. N must divide by sp.
  * Ring (`ring_attention`): every rank keeps all heads and its query
    shard; the key/value shards travel round the ring. Each step is one K1
    launch over the shard in hand that also writes each row's natural-log
    LSE (`ops.attention.attention_with_lse`), merged into the running
    (out, lse) in f32, while the next shard's send and receive are in
    flight (`collectives.ring_exchange`). Only LSEs of the same kind of
    launch are merged, so their units agree.
  * USP (`usp_attention`): Ulysses inside the "sp_u" group, then the ring
    over "sp_r"; the heads need only divide by the Ulysses degree.

Where JAX's functions take the global view inside `shard_map`, these take
this rank's shard: q/k/v [B, L/sp, N, D] in, [B, L/sp, N, D] out.
`make_*_attention(mesh)` return an `SPAttention`, the callable that
`wan_dit.dit_forward(sp_attn=)` takes, with the rank's token chunk and the
group the head's output is gathered over. Inference only: no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from realtime_video_tpu_torch.ops import attention as attn_ops
from realtime_video_tpu_torch.parallel import collectives as coll
from realtime_video_tpu_torch.parallel import mesh as mesh_mod


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, L/P, N, D] -> [B, L, N/P, D]: head group j goes to group rank j,
    whose tokens come back in rank order (the all-to-all of
    sequence.py:60-66)."""
    p = _group_size(group)
    b, lq, n, d = x.shape
    if n % p:
        raise ValueError(f"Ulysses over {p} ranks needs heads divisible by {p}, got {n}")
    xs = x.reshape(b, lq, p, n // p, d).permute(2, 0, 1, 3, 4)  # [P, B, L/P, N/P, D]
    y = coll.all_to_all(xs, group)  # y[j]: rank j's tokens of this rank's heads
    return y.permute(1, 0, 2, 3, 4).reshape(b, p * lq, n // p, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, L, N/P, D] -> [B, L/P, N, D], the inverse of `seq_to_heads`."""
    p = _group_size(group)
    b, L, nl, d = x.shape
    xs = x.reshape(b, p, L // p, nl, d).permute(1, 0, 2, 3, 4)  # [P, B, L/P, N/P, D]
    y = coll.all_to_all(xs, group)  # y[j]: this rank's tokens of head group j
    return y.permute(1, 2, 0, 3, 4).reshape(b, L // p, p * nl, d)


def merge_partial(out: Optional[torch.Tensor], lse: Optional[torch.Tensor],
                  o: torch.Tensor, lse_o: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one key shard's (o [B, Lq, N, D], lse_o [B, N, Lq]) into the
    running (out f32, lse): out <- out e^(lse - new) + o e^(lse_o - new),
    new = logaddexp(lse, lse_o)."""
    if out is None:
        return o.float(), lse_o
    new = torch.logaddexp(lse, lse_o)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    c = torch.exp(lse_o - new).transpose(1, 2)[..., None]
    return out * a + o.float() * c, new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's queries over every rank's keys, the
    key/value shards rotating round the ring `group` (sequence.py:81-132).
    With one rank it is the unmasked window itself."""
    size = _group_size(group)
    if size == 1:
        return attn_ops.attention(q, k, v, scale=scale)
    out = lse = None
    kc, vc = k.contiguous(), v.contiguous()
    for step in range(size):
        reqs = None
        if step < size - 1:  # the next shard in flight under this step's launch
            (kn, vn), reqs = coll.ring_exchange([kc, vc], group)
        o, lse_o = attn_ops.attention_with_lse(q, kc, vc, scale)
        out, lse = merge_partial(out, lse, o, lse_o)
        if reqs is not None:
            coll.wait(reqs)
            kc, vc = kn, vn
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence-sharded batch by two all-to-alls
    (sequence.py:53-78)."""
    qg, kg, vg = (seq_to_heads(t, group) for t in (q, k, v))
    o = attn_ops.attention(qg, kg, vg, scale=scale, bound_group=group)
    return heads_to_seq(o, group)


def usp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ulysses_group,
                  ring_group, scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses inside `ulysses_group`, the ring over `ring_group`
    (sequence.py:135-159)."""
    if _group_size(ulysses_group) == 1:
        return ring_attention(q, k, v, ring_group, scale)
    if _group_size(ring_group) == 1:
        return ulysses_attention(q, k, v, ulysses_group, scale)
    qg, kg, vg = (seq_to_heads(t, ulysses_group) for t in (q, k, v))
    return heads_to_seq(ring_attention(qg, kg, vg, ring_group, scale), ulysses_group)


@dataclasses.dataclass(frozen=True)
class SPAttention:
    """The self-attention of a sequence-sharded forward: call it on this
    rank's q, k, v. `rank` is the index of this rank's token chunk of `size`,
    `gather_group` the group (in chunk order) the head's output is gathered
    over (None for a single chunk)."""

    size: int
    rank: int
    gather_group: object
    ulysses_group: object = None
    ring_group: object = None

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return usp_attention(q, k.contiguous(), v.contiguous(), self.ulysses_group,
                             self.ring_group)


def _chunk(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(chunks, this rank's chunk) of a sequence split over `axes`, major first."""
    size, index = 1, 0
    for ax in axes:
        n = mesh_mod.axis_size(mesh, ax)
        size, index = size * n, index * n + mesh_mod.axis_rank(mesh, ax)
    return size, index


def _gather_group(mesh, axes: Sequence[str]):
    """The group whose ranks, in group-rank order, hold the chunks in order:
    the one axis of more than one rank, or the whole world when the mesh
    covers it with the chunk index as the global rank."""
    split = [ax for ax in axes if mesh_mod.axis_size(mesh, ax) > 1]
    if len(split) <= 1:
        return mesh_mod.axis_group(mesh, split[0]) if split else None
    size, index = _chunk(mesh, axes)
    if size != dist.get_world_size() or index != dist.get_rank():
        raise ValueError("a sequence split over two axes needs a mesh over the whole world, "
                         "in rank order")
    return dist.group.WORLD


def make_usp_attention(mesh, ulysses_axis: str = "sp_u", ring_axis: str = "sp_r") -> SPAttention:
    """USP over the (ring, Ulysses) axes: tokens split over both, ring major
    (sequence.py:162-183)."""
    size, index = _chunk(mesh, (ring_axis, ulysses_axis))
    return SPAttention(size, index, _gather_group(mesh, (ring_axis, ulysses_axis)),
                       mesh_mod.axis_group(mesh, ulysses_axis),
                       mesh_mod.axis_group(mesh, ring_axis))


def make_ring_attention(mesh, axis: str = "sp") -> SPAttention:
    """The pure ring: no condition on the heads (sequence.py:186-197)."""
    size, index = _chunk(mesh, (axis,))
    return SPAttention(size, index, _gather_group(mesh, (axis,)),
                       ring_group=mesh_mod.axis_group(mesh, axis))


def make_sp_attention(mesh, axis: str = "sp") -> SPAttention:
    """Ulysses over `axis`: the heads must divide by its size
    (sequence.py:200-219)."""
    size, index = _chunk(mesh, (axis,))
    return SPAttention(size, index, _gather_group(mesh, (axis,)),
                       ulysses_group=mesh_mod.axis_group(mesh, axis))


def shard_sequence(x: torch.Tensor, mesh, axis: Union[str, Sequence[str]] = "sp",
                   dim: int = 1) -> torch.Tensor:
    """This rank's contiguous chunk of x along `dim` over the mesh `axis`
    (a tuple of axes splits major first, as JAX's (ring, ulysses) spec)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    size, index = _chunk(mesh, axes)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {size} ranks")
    step = x.shape[dim] // size
    return x.narrow(dim, index * step, step).contiguous()
