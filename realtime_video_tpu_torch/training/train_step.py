"""The training step on one device (port of
realtime_video_tpu/training/train_step.py).

The JAX step shards params over a dp x tp mesh and takes an optax AdamW
step; here the step runs on one device with `torch.optim.AdamW`, whose
decoupled weight decay is optax.adamw's (the decay taken on the params
before the update, eps 1e-8 outside the square root, betas 0.9 / 0.999).
Adam's m and v are kept in the params' dtype, as optax keeps them. The
dp / tp sharding waits for the port's multi-GPU slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.training import ema as ema_mod
from realtime_video_tpu_torch.training.draws import Draws
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


def make_train_state(gen: WanDiffusion, learning_rate: float = 1e-5,
                     weight_decay: float = 0.01) -> Tuple[Any, torch.optim.AdamW]:
    """(params, optimizer): the generator's params set to require grad (in
    place) and AdamW over them."""
    params = trainable(gen.params)
    return params, adamw(params, learning_rate, weight_decay)


def make_train_step(gen: WanDiffusion, optimizer: torch.optim.Optimizer,
                    num_frame_per_block: int = 3, ema_decay: Optional[float] = None):
    """step(params, latents, prompt_embeds, draws, ema=None) -> metrics: the
    causal flow-matching loss, its backward, one optimizer step on `params`
    in place, and, with `ema_decay`, the fp32 EMA shadow `ema` updated in
    place (EMA_FSDP, utils/distributed.py:91-125)."""

    def step(params, latents, prompt_embeds, draws: Draws,
             ema: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = causal_flow_matching_loss(
            gen, params, latents, prompt_embeds, draws,
            num_frame_per_block=num_frame_per_block)
        loss.backward()
        optimizer.step()
        if ema_decay is not None:
            if ema is None:
                raise ValueError("make_train_step(ema_decay=...) needs the `ema` shadow")
            ema_mod.ema_update(ema, params, ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

    return step
