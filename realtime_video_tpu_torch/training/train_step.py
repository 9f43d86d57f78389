"""The training step, on one device or a dp x tp mesh (port of
realtime_video_tpu/training/train_step.py).

The JAX step shards params over a dp x tp mesh and takes an optax AdamW
step; here `torch.optim.AdamW` takes it, whose decoupled weight decay is
optax.adamw's (the decay taken on the params before the update, eps 1e-8
outside the square root, betas 0.9 / 0.999). Adam's m and v are kept in the
params' dtype, as optax keeps them.

On a mesh (one process a rank, `parallel/launch.py`) each rank holds its tp
slice of the tree (`parallel/sharding.py`), and AdamW and the EMA run on
that slice, which is the JAX step's update sliced, since both are
elementwise. The batch is split over "dp": every rank is handed the whole
batch, keeps its rows, and draws the whole batch's timesteps and noise in
the JAX code's order, keeping its rows too (`DataParallelDraws`). The loss is
the mean over the rank's rows; its gradients are averaged over dp (summed,
then divided by dp), which is the gradient of the whole batch's mean. Over
tp the forward's collectives (`models/wan_dit.py`) make every rank's
gradient of a replicated leaf the whole gradient, so replicated leaves stay
equal on every tp rank without a reduction of their own.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.parallel import collectives as coll
from realtime_video_tpu_torch.parallel import mesh as mesh_mod
from realtime_video_tpu_torch.parallel import sharding
from realtime_video_tpu_torch.training import ema as ema_mod
from realtime_video_tpu_torch.training.draws import DataParallelDraws, Draws
from realtime_video_tpu_torch.training.losses import (
    causal_flow_matching_loss,
    trainable,
    tree_leaves,
)


def adamw(params: Any, learning_rate: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """torch AdamW over the floating leaves of `params`, with optax.adamw's
    defaults; foreach off, so that every leaf takes the same arithmetic."""
    leaves = [t for t in tree_leaves(params).values() if t.is_floating_point()]
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, foreach=False)


def make_train_state(gen: WanDiffusion, mesh=None, learning_rate: float = 1e-5,
                     weight_decay: float = 0.01) -> Tuple[Any, torch.optim.AdamW]:
    """(params, optimizer): the generator's params, or with a `mesh` this
    rank's tp slice of them, set to require grad (in place), and AdamW over
    them. The generator holds the whole tree (no mesh of its own)."""
    if mesh is not None and gen.mesh is not None:
        raise ValueError("make_train_state slices the generator's whole tree: build it "
                         "without a mesh")
    params = trainable(sharding.shard_wan_params(gen.params, mesh))
    return params, adamw(params, learning_rate, weight_decay)


def make_train_step(gen: WanDiffusion, optimizer: torch.optim.Optimizer, mesh=None,
                    num_frame_per_block: int = 3, ema_decay: Optional[float] = None):
    """step(params, latents, prompt_embeds, draws, ema=None) -> metrics: the
    causal flow-matching loss, its backward, one optimizer step on `params`
    in place, and, with `ema_decay`, the fp32 EMA shadow `ema` updated in
    place (EMA_FSDP, utils/distributed.py:91-125). On a `mesh`, latents and
    prompt_embeds are the whole batch (its size a multiple of dp) and the
    metrics the whole batch's (see the module note)."""
    dp = mesh_mod.axis_size(mesh, "dp")
    dp_rank, dp_group = mesh_mod.axis_rank(mesh, "dp"), mesh_mod.axis_group(mesh, "dp")

    def step(params, latents, prompt_embeds, draws: Draws,
             ema: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        if latents.shape[0] % dp:
            raise ValueError(f"batch {latents.shape[0]} does not split over dp={dp}")
        if dp > 1:
            b = latents.shape[0] // dp
            rows = slice(dp_rank * b, (dp_rank + 1) * b)
            latents, prompt_embeds = latents[rows], prompt_embeds[rows]
            draws = DataParallelDraws(draws, dp, dp_rank)
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = causal_flow_matching_loss(
            gen, params, latents, prompt_embeds, draws,
            num_frame_per_block=num_frame_per_block, mesh=mesh)
        loss.backward()
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        if dp > 1:
            grads = [t.grad for t in tree_leaves(params).values() if t.grad is not None]
            coll.all_reduce_mean_(grads + list(metrics.values()), dp_group)
        optimizer.step()
        if ema_decay is not None:
            if ema is None:
                raise ValueError("make_train_step(ema_decay=...) needs the `ema` shadow")
            ema_mod.ema_update(ema, params, ema_decay)
        return metrics

    return step
