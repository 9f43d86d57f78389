"""Training-time autoregressive rollout, "backward simulation" (port of
realtime_video_tpu/pipelines/self_forcing_training.py; reference
pipeline/self_forcing_training.py).

The causal generator rolls out block by block through a KV cache. Each
block keeps the gradient at ONE randomly chosen denoising step (:136-204);
after each block the cache is refreshed with the block's clean latents,
corrupted by context noise when asked (:226-272).

In PyTorch's idiom:
  * the steps before the chosen one run under `torch.no_grad()`, and the
    loop stops at the chosen step, as the reference breaks out of it. The
    JAX package runs every step and selects with `where` / `stop_gradient`:
    the same value and gradient, since a later step writes only K/V that the
    refresh overwrites. Their draws are still made, in JAX's order;
  * the chosen step and the refresh keep their graph, and the refresh's K/V
    go into the training cache (`kv_cache.init_train_kv_cache`), so the
    parameter gradient flows through them into the later blocks, as in JAX,
    where only the refresh's input x0 is stopped;
  * the last block's refresh is skipped: nothing reads its K/V;
  * randomness (exit flags, renoise, context noise) comes through `Draws`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.training.draws import Draws


class SelfForcingTrainingPipeline:
    def __init__(
        self,
        denoising_step_list,
        scheduler,
        generator: WanDiffusion,
        num_frame_per_block: int = 3,
        independent_first_frame: bool = False,
        same_step_across_blocks: bool = True,
        last_step_only: bool = False,
        context_noise: float = 0.0,
        kv_cache_frames: int = 21,
        max_num_context_frames: int = 21,
    ):
        self.independent_first_frame = independent_first_frame  # stored, unused, as in JAX
        self.denoising_step_list = tuple(float(t) for t in denoising_step_list)
        self.scheduler = scheduler
        self.generator = generator
        self.num_frame_per_block = num_frame_per_block
        self.same_step_across_blocks = same_step_across_blocks
        self.last_step_only = last_step_only
        self.context_noise = float(context_noise)
        self.kv_cache_frames = kv_cache_frames
        self.max_num_context_frames = max_num_context_frames

    def sample_exit_flags(self, draws: Draws, num_blocks: int) -> List[int]:
        """The denoise-step index at which each block keeps its gradient
        (generate_and_sync_list, :41-58), host ints."""
        n = len(self.denoising_step_list)
        if self.last_step_only:
            return [n - 1] * num_blocks
        flags = [int(x) for x in draws.randint(0, n, (num_blocks,))]
        if self.same_step_across_blocks:
            flags = [flags[0]] * num_blocks
        return flags

    def inference_with_trajectory(
        self,
        params: Dict[str, Any],
        noise: torch.Tensor,  # [B, F, C, h, w]
        crossattn_cache: Dict[str, torch.Tensor],
        draws: Draws,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred [B, F, C, h, w] with the gradient of the chosen steps when
        grad is enabled, exit flags [num_blocks] int32)."""
        gen = self.generator
        b, f, c, h, w = noise.shape
        nfpb = self.num_frame_per_block
        fsl = gen.cfg.frame_seq_length(h, w)
        if f % nfpb:
            raise ValueError(f"{f} frames are not whole blocks of {nfpb}")
        num_blocks = f // nfpb
        max_attn = self.max_num_context_frames * fsl
        grad = torch.is_grad_enabled()
        exit_flags = self.sample_exit_flags(draws, num_blocks)
        kv = kvc.init_train_kv_cache(gen.cfg.num_layers, self.kv_cache_frames * fsl)
        steps = self.denoising_step_list

        def forward(x, t_val, start, keep_graph):
            t = torch.full((b, nfpb), t_val, dtype=torch.float32, device=noise.device)
            with torch.set_grad_enabled(grad and keep_graph):
                _, x0, _ = gen.forward(x, crossattn_cache, t, kv_cache=kv, current_start=start,
                                       mode="decode", max_attention_size=max_attn,
                                       params=params)
            return x0

        outputs = []
        for blk in range(num_blocks):
            lo = blk * nfpb
            start = lo * fsl
            noisy = noise[:, lo:lo + nfpb]
            chosen = exit_flags[blk]
            for i, t_val in enumerate(steps):
                if i <= chosen:
                    x0_i = forward(noisy, t_val, start, i == chosen)
                if i < len(steps) - 1:
                    nz = draws.normal(noisy.shape, noisy.dtype, noisy.device)
                    if i < chosen:
                        t_next = torch.full((b, nfpb), steps[i + 1], dtype=torch.float32,
                                            device=noise.device)
                        noisy = self.scheduler.add_noise(x0_i.detach(), nz, t_next)
                if i == chosen:
                    x0 = x0_i
            outputs.append(x0)

            # cache refresh with the (context-noised) clean latents; the input
            # carries no gradient, its K/V do
            refresh_in = x0.detach()
            t_ctx = 0.0
            if self.context_noise > 0:
                nz = draws.normal(refresh_in.shape, refresh_in.dtype, refresh_in.device)
                t_ctx = self.context_noise
                refresh_in = self.scheduler.add_noise(
                    refresh_in, nz, torch.full((b, nfpb), t_ctx, dtype=torch.float32,
                                               device=noise.device))
            if blk < num_blocks - 1:
                forward(refresh_in, t_ctx, start, True)
        pred = torch.cat(outputs, dim=1)
        return pred, torch.tensor(exit_flags, dtype=torch.int32)
