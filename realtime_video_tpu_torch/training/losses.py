"""Denoising losses (port of realtime_video_tpu/training/losses.py; reference
utils/loss.py:27-81 and model/diffusion.py's flow-matching pretraining loss).

The server config uses denoising_loss_type: flow: target v = noise - x0.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.training.draws import Draws


def _mse(pred, target, weights=None):
    err = (pred.float() - target.float()) ** 2
    if weights is not None:
        err = err * weights.reshape(weights.shape + (1,) * (err.dim() - weights.dim()))
    return err.mean()


def denoising_loss(loss_type: str, pred, target, xt=None, timestep=None, schedule=None,
                   weights=None):
    """x0 / noise / velocity (flow) losses (utils/loss.py:27-81): each an MSE
    between the prediction and its target, optionally weighted per frame."""
    del xt, timestep, schedule
    if loss_type in ("flow", "v", "x0", "noise"):
        return _mse(pred, target, weights)
    raise ValueError(loss_type)


def sample_block_timesteps(draws: Draws, batch: int, num_frames: int,
                           num_frame_per_block: int, num_train_timesteps: int = 1000,
                           min_t: int = 0, device=None) -> torch.Tensor:
    """Block-consistent random timesteps [B, F] f32 on `device`: every frame
    of a block shares one timestep (model/base.py:48-95)."""
    nb = num_frames // num_frame_per_block
    t = draws.randint(min_t, num_train_timesteps, (batch, nb))
    return t.repeat_interleave(num_frame_per_block, dim=1).to(device=device,
                                                               dtype=torch.float32)


def causal_flow_matching_loss(
    gen: WanDiffusion,
    params: Dict[str, Any],
    latents: torch.Tensor,  # [B, F, C, H, W] clean
    prompt_embeds: torch.Tensor,  # [B, T, text_dim]
    draws: Draws,
    num_frame_per_block: int = 3,
    loss_type: str = "flow",
    context_noise_max: int = 0,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal diffusion pretraining loss (model/diffusion.py:86-113): a
    block-causal train-mode forward of `params` on noised latents against the
    flow target. The cross-attention K/V are computed inside the loss, so
    their projections get gradients too. With a tp `mesh`, `params` is this
    rank's slice and the forward the tensor-parallel one."""
    del context_noise_max
    b, f, c, h, w = latents.shape
    fsl = gen.cfg.frame_seq_length(h, w)
    t = sample_block_timesteps(draws, b, f, num_frame_per_block, device=latents.device)
    noise = draws.normal(latents.shape, latents.dtype, latents.device)
    noisy = gen.schedule.add_noise(latents, noise, t)
    cross = wan_dit.compute_crossattn_cache(gen.cfg, params, prompt_embeds, mesh=mesh)
    flow_pred, _ = wan_dit.dit_forward(gen.cfg, params, noisy, t, gen.rope, cross, mode="train",
                                       block_tokens=fsl * num_frame_per_block, mesh=mesh)
    target = gen.schedule.training_target(latents, noise, t)
    weights = gen.schedule.training_weight(t)
    loss = denoising_loss(loss_type, flow_pred, target, weights=weights)
    return loss, {"loss": loss, "mean_timestep": t.mean()}


def tree_leaves(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a/b/c": tensor} of nested dicts, lists and tuples of tensors, in
    insertion order; a list or tuple item's key is its index ("blocks/0/w")."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix[:-1]: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(tree_leaves(v, f"{prefix}{k}/"))
    return out


def trainable(tree: Any) -> Any:
    """`tree` with every floating leaf set to require grad, in place (no
    copy); returned for convenience."""
    for t in tree_leaves(tree).values():
        if t.is_floating_point():
            t.requires_grad_(True)
    return tree
