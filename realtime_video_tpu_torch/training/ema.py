"""EMA shadow weights for distillation training (port of
realtime_video_tpu/training/ema.py; reference utils/distributed.py:91-125,
`EMA_FSDP`): an fp32 shadow copy of the generator, updated after every
optimizer step, shadow = decay * shadow + (1 - decay) * param.

The JAX package donates the shadow to a jitted update; here the update runs
in place with `torch._foreach_*` (one fused pass per dtype group).
"""
from __future__ import annotations

from typing import Any

import torch

from realtime_video_tpu_torch.training.losses import tree_leaves


def _map(fn, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_ema(params: Any, dtype=torch.float32) -> Any:
    """A fresh shadow copy of `params` in `dtype` (fp32 by default, as
    EMA_FSDP keeps it), detached from any graph."""
    return _map(lambda p: p.detach().to(dtype=dtype, copy=True), params)


@torch.no_grad()
def ema_update(shadow: Any, params: Any, decay: float = 0.999) -> Any:
    """shadow <- shadow * decay + params * (1 - decay), in place; returns
    `shadow`."""
    s = list(tree_leaves(shadow).values())
    p = [x.detach().to(y.dtype) for x, y in zip(tree_leaves(params).values(), s)]
    torch._foreach_mul_(s, decay)
    torch._foreach_add_(s, p, alpha=1.0 - decay)
    return shadow


def ema_params(shadow: Any, like: Any) -> Any:
    """The shadow cast back to the live params' dtypes for eval
    (EMA_FSDP.copy_to, utils/distributed.py:117-121)."""
    return _map(lambda s, p: s.to(p.dtype), shadow, like)
