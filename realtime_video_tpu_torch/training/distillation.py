"""Distribution Matching Distillation (DMD) and relatives (port of
realtime_video_tpu/training/distillation.py; reference model/dmd.py,
model/sid.py, model/causvid.py, model/ode_regression.py).

  * DMD: a causal generator, a frozen real score and a trainable fake score
    (both bidirectional); the KL gradient fake - real (with CFG on the real
    score) normalised by mean|x0 - real| and applied through the MSE to
    (x0 - grad) (dmd.py:117-195); the critic trains the fake score with the
    flow denoising loss (dmd.py:238-333);
  * SiD, CausVid and the ODE regression loss.

The JAX losses are pure functions differentiated by `jax.value_and_grad`;
here each returns a loss whose `backward()` fills the `.grad` of the
trainable tree passed in (`losses.trainable`). What JAX stops with
`stop_gradient` is detached, and the score forwards that no gradient passes
through run under `torch.no_grad()`. The score networks' all-true mask
(`_full_mask`) is passed as no mask: K1's unmasked window. Randomness comes
through `Draws`, in the JAX code's order of draws.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.pipelines.self_forcing_training import (
    SelfForcingTrainingPipeline,
)
from realtime_video_tpu_torch.training.draws import Draws
from realtime_video_tpu_torch.training.losses import sample_block_timesteps

Params = Dict[str, Any]


class DMD:
    """The three networks and the hyperparameters; `generator_loss` and
    `critic_loss` of the trainable trees."""

    def __init__(self, generator: WanDiffusion, real_score: WanDiffusion,
                 fake_score: WanDiffusion, config):
        self.generator = generator
        self.real_score = real_score
        self.fake_score = fake_score
        self.guidance_scale = float(config.get("guidance_scale", 3.0))
        self.min_step = int(0.02 * 1000)
        self.max_step = int(0.98 * 1000)
        self.num_frame_per_block = config.get("num_frame_per_block", 3)
        self.pipeline = SelfForcingTrainingPipeline(
            config.get("denoising_step_list", [1000, 750, 500, 250]),
            generator.schedule,
            generator,
            num_frame_per_block=self.num_frame_per_block,
            same_step_across_blocks=config.get("same_step_across_blocks", True),
            last_step_only=config.get("last_step_only", False),
            context_noise=config.get("context_noise", 0),
        )

    def _score_x0(self, score: WanDiffusion, params: Params, noisy, t, cross) -> torch.Tensor:
        _, x0, _ = score.forward(noisy, cross, t, mode="train", params=params)
        return x0

    def _noisy_scores(self, x0_gen, cross_cond, cross_uncond, fake_params, draws: Draws):
        """(pred_fake, pred_real with CFG) at a random block timestep of the
        detached x0 (dmd.py:129-170), without a graph."""
        b, f = x0_gen.shape[:2]
        t = sample_block_timesteps(draws, b, f, self.num_frame_per_block, min_t=self.min_step,
                                   device=x0_gen.device)
        t = t.clamp(self.min_step, self.max_step)
        noise = draws.normal(x0_gen.shape, x0_gen.dtype, x0_gen.device)
        noisy = self.generator.schedule.add_noise(x0_gen.detach(), noise, t)
        with torch.no_grad():
            pred_fake = self._score_x0(self.fake_score, fake_params, noisy, t, cross_cond)
            real = self.real_score.params
            pred_real_cond = self._score_x0(self.real_score, real, noisy, t, cross_cond)
            pred_real_uncond = self._score_x0(self.real_score, real, noisy, t, cross_uncond)
        pred_real = pred_real_cond + self.guidance_scale * (pred_real_cond - pred_real_uncond)
        return pred_fake, pred_real

    # -- distribution matching loss (dmd.py:129-195) -----------------------

    def distribution_matching_loss(self, x0_gen: torch.Tensor, cross_cond, cross_uncond,
                                   fake_params: Params, draws: Draws) -> torch.Tensor:
        pred_fake, pred_real = self._noisy_scores(x0_gen, cross_cond, cross_uncond,
                                                  fake_params, draws)
        x0 = x0_gen.float()
        grad = (pred_fake - pred_real).float()
        # per-sample normaliser (dmd.py:117-121)
        normalizer = (x0 - pred_real.float()).abs().mean(dim=(1, 2, 3, 4), keepdim=True)
        grad = torch.nan_to_num(grad / normalizer.clamp(min=1e-6))
        # MSE trick: d/dx 0.5 ||x - sg(x - grad)||^2 = grad (dmd.py:189-195)
        target = (x0 - grad).detach()
        return 0.5 * ((x0 - target) ** 2).mean()

    # -- generator loss (dmd.py:197-236) -------------------------------------

    def generator_loss(self, gen_params: Params, fake_params: Params, noise: torch.Tensor,
                       cross_cond, cross_uncond, draws: Draws
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x0_gen, _ = self.pipeline.inference_with_trajectory(gen_params, noise, cross_cond, draws)
        loss = self.distribution_matching_loss(x0_gen, cross_cond, cross_uncond, fake_params,
                                               draws)
        return loss, {"dmd_loss": loss}

    # -- critic loss (dmd.py:238-333) ------------------------------------------

    def critic_loss(self, fake_params: Params, gen_params: Params, noise: torch.Tensor,
                    cross_cond, draws: Draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        with torch.no_grad():
            x0_gen, _ = self.pipeline.inference_with_trajectory(gen_params, noise, cross_cond,
                                                                draws)
        b, f = x0_gen.shape[:2]
        t = sample_block_timesteps(draws, b, f, self.num_frame_per_block, device=x0_gen.device)
        nz = draws.normal(x0_gen.shape, x0_gen.dtype, x0_gen.device)
        sched = self.fake_score.schedule
        noisy = sched.add_noise(x0_gen, nz, t)
        flow_pred, _, _ = self.fake_score.forward(noisy, cross_cond, t, mode="train",
                                                  params=fake_params)
        target = sched.training_target(x0_gen, nz, t)
        weights = sched.training_weight(t)
        w_ = weights.reshape(weights.shape + (1,) * (flow_pred.dim() - weights.dim()))
        loss = (w_ * (flow_pred.float() - target.float()) ** 2).mean()
        return loss, {"critic_loss": loss}


class SiD(DMD):
    """Score identity Distillation (model/sid.py): loss = mean of (real -
    fake) * ((real - x0) - alpha (real - fake)) / normalizer."""

    def __init__(self, generator, real_score, fake_score, config):
        super().__init__(generator, real_score, fake_score, config)
        self.sid_alpha = float(config.get("sid_alpha", 1.0))

    def distribution_matching_loss(self, x0_gen, cross_cond, cross_uncond, fake_params,
                                   draws) -> torch.Tensor:
        pred_fake, pred_real = self._noisy_scores(x0_gen, cross_cond, cross_uncond,
                                                  fake_params, draws)
        pr, pf, x0 = pred_real.float(), pred_fake.float(), x0_gen.float()
        sid = (pr - pf) * ((pr - x0) - self.sid_alpha * (pr - pf))
        normalizer = (x0 - pr).abs().mean(dim=(1, 2, 3, 4), keepdim=True).detach()
        return torch.nan_to_num(sid / normalizer.clamp(min=1e-6)).mean()


class CausVid(DMD):
    """CausVid (model/causvid.py): the generator's inputs are clean data
    noised to a random step of the list, and one block-causal train-mode
    forward predicts x0, in place of the autoregressive rollout."""

    def run_generator(self, gen_params: Params, clean_latent: torch.Tensor, cross_cond,
                      draws: Draws) -> torch.Tensor:
        b, f, c, h, w = clean_latent.shape
        nfpb = self.num_frame_per_block
        fsl = self.generator.cfg.frame_seq_length(h, w)
        steps = torch.tensor(self.pipeline.denoising_step_list, dtype=torch.float32)
        idx = draws.randint(0, len(steps), (b, f // nfpb))
        t = steps[idx].repeat_interleave(nfpb, dim=1).to(clean_latent.device)
        noise = draws.normal(clean_latent.shape, clean_latent.dtype, clean_latent.device)
        noisy = self.generator.schedule.add_noise(clean_latent, noise, t)
        _, x0, _ = self.generator.forward(noisy, cross_cond, t, mode="train",
                                          block_tokens=fsl * nfpb, params=gen_params)
        return x0

    def generator_loss(self, gen_params, fake_params, noise, cross_cond, cross_uncond, draws,
                       clean_latent: Optional[torch.Tensor] = None):
        if clean_latent is None:
            raise ValueError("CausVid needs clean data latents")
        x0_gen = self.run_generator(gen_params, clean_latent, cross_cond, draws)
        loss = self.distribution_matching_loss(x0_gen, cross_cond, cross_uncond, fake_params,
                                               draws)
        return loss, {"dmd_loss": loss}


def ode_regression_loss(
    generator: WanDiffusion,
    params: Params,
    noisy_input: torch.Tensor,  # [B, F, C, h, w] trajectory point at the sampled step
    target_x0: torch.Tensor,  # [B, F, C, h, w] the ODE's end point
    timestep: torch.Tensor,  # [B, F]
    crossattn_cache: Dict[str, torch.Tensor],
    num_frame_per_block: int = 3,
) -> torch.Tensor:
    """Regression onto precomputed ODE pairs (model/ode_regression.py:56-138):
    the causal generator predicts the trajectory's end point from an
    intermediate point, in one block-causal train-mode forward; MSE on x0."""
    h, w = noisy_input.shape[-2:]
    fsl = generator.cfg.frame_seq_length(h, w)
    _, x0, _ = generator.forward(noisy_input, crossattn_cache, timestep, mode="train",
                                 block_tokens=fsl * num_frame_per_block, params=params)
    return ((x0.float() - target_x0.float()) ** 2).mean()
