"""Adversarial distillation (port of realtime_video_tpu/training/gan.py;
reference model/gan.py).

The fake score doubles as a discriminator: a classifier branch taps DiT
features at three layers, register tokens cross-attend to them
(model.py:775-795 + GanAttentionBlock / RegisterTokens), and a small MLP
predicts real / fake logits (`wan_dit.dit_classify`). The generator gets a
non-saturating GAN term on top of DMD; the critic gets the relativistic or
the standard adversarial loss, with optional R1 / R2 noise-perturbation
penalties (gan.py:57-62).

As in `distillation.py`, each loss returns a value whose `backward()` fills
the `.grad` of the trainable trees passed in, and every random draw goes
through `Draws` in the JAX code's order: the generator's rollout, DMD's
timesteps and noise, the GAN timesteps, the logits' noise; the critic's
rollout, the GAN timesteps, the fake logits' noise, then DMD's critic loss
with its own rollout, then the real logits' noise. The JAX code draws the
R1 / R2 perturbations and the perturbed logits' noise from the keys of the
real / fake logits' noise, so those are the same numbers: the port reuses
those two draws rather than making new ones.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from realtime_video_tpu_torch.config import WanModelConfig
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.training.distillation import DMD
from realtime_video_tpu_torch.training.draws import Draws
from realtime_video_tpu_torch.training.losses import sample_block_timesteps

Params = Dict[str, Any]

DEFAULT_TAPS = (13, 21, 29)  # reference feature taps (model.py:785)
#: the seed of the head's init when none is given (the JAX package's PRNGKey(7))
GAN_HEAD_SEED = 7


def init_gan_head_params(generator: torch.Generator, cfg: WanModelConfig, num_class: int = 1,
                         num_registers: int = 3, concat_time: bool = False,
                         dtype=torch.float32, device=None) -> Params:
    """Register tokens, GanAttentionBlocks and the class MLP
    (wan_wrapper.py:159-177 adding_cls_branch), in the JAX package's
    structure and distributions, drawn from `generator` on `device`."""
    d = cfg.dim

    def lin(din, dout):
        lim = math.sqrt(6.0 / (din + dout))
        w = torch.empty((din, dout), dtype=torch.float32, device=device).uniform_(
            -lim, lim, generator=generator)
        return {"w": w.to(dtype), "b": torch.zeros((dout,), dtype=dtype, device=device)}

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def gan_block():
        return {
            "norm3": {"scale": ones(d), "bias": torch.zeros((d,), dtype=dtype, device=device)},
            "cross_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                           "norm_q": {"scale": ones(d)}, "norm_k": {"scale": ones(d)}},
            "ffn": {"fc1": lin(d, cfg.ffn_dim), "fc2": lin(cfg.ffn_dim, d)},
        }

    registers = torch.randn((num_registers, d), generator=generator, dtype=torch.float32,
                            device=device) * 0.02
    in_dim = num_registers * d + (d if concat_time else 0)
    return {
        "register_tokens": registers.to(dtype),
        "register_norm": {"scale": ones(d)},
        "blocks": [gan_block() for _ in range(num_registers)],
        "cls_head": {
            "norm": {"scale": ones(in_dim),
                     "bias": torch.zeros((in_dim,), dtype=dtype, device=device)},
            "fc1": lin(in_dim, d),
            "fc2": lin(d, num_class),
        },
    }


def _detached(tree: Any) -> Any:
    """`tree` with every leaf detached: a forward through it keeps a graph to
    its inputs only."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach()


class GAN(DMD):
    """DMD + the adversarial term (model/gan.py). The critic's trainable
    params are the pair (fake-score params, GAN head params)."""

    def __init__(self, generator, real_score, fake_score, config,
                 gan_params: Optional[Params] = None):
        super().__init__(generator, real_score, fake_score, config)
        self.gan_g_weight = float(config.get("gan_g_weight", 1e-2))
        self.gan_d_weight = float(config.get("gan_d_weight", 1e-2))
        self.r1_weight = float(config.get("r1_weight", 0.0))
        self.r2_weight = float(config.get("r2_weight", 0.0))
        self.r1_sigma = float(config.get("r1_sigma", 0.01))
        self.r2_sigma = float(config.get("r2_sigma", 0.01))
        self.relativistic = bool(config.get("relativistic_discriminator", False))
        self.concat_time = bool(config.get("concat_time_embeddings", False))
        nl = fake_score.cfg.num_layers
        self.taps = tuple(tl for tl in config.get("gan_taps", DEFAULT_TAPS) if tl < nl) \
            or (nl - 1,)
        if gan_params is None:
            gen = torch.Generator(device=fake_score.device).manual_seed(GAN_HEAD_SEED)
            gan_params = init_gan_head_params(
                gen, fake_score.cfg, num_class=int(config.get("num_class", 1)),
                num_registers=len(self.taps), concat_time=self.concat_time,
                device=fake_score.device)
        self.gan_params = gan_params

    def _logits(self, fake_params: Params, gan_params: Params, x0: torch.Tensor,
                t: torch.Tensor, cross, noise: torch.Tensor) -> torch.Tensor:
        """The discriminator's logits of x0 noised to t with `noise`."""
        noisy = self.fake_score.schedule.add_noise(x0, noise, t)
        return wan_dit.dit_classify(self.fake_score.cfg, fake_params, noisy, t,
                                    self.fake_score.rope, cross, gan_params, taps=self.taps,
                                    concat_time=self.concat_time)

    def _gan_timesteps(self, x0: torch.Tensor, draws: Draws) -> torch.Tensor:
        b, f = x0.shape[:2]
        return sample_block_timesteps(draws, b, f, self.num_frame_per_block, device=x0.device)

    def generator_loss(self, gen_params: Params, fake_params: Params, noise: torch.Tensor,
                       cross_cond, cross_uncond, draws: Draws
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x0_gen, _ = self.pipeline.inference_with_trajectory(gen_params, noise, cross_cond, draws)
        dmd = self.distribution_matching_loss(x0_gen, cross_cond, cross_uncond, fake_params,
                                              draws)
        t = self._gan_timesteps(x0_gen, draws)
        nz = draws.normal(x0_gen.shape, x0_gen.dtype, x0_gen.device)
        # the gradient reaches the generator through x0 only
        logits = self._logits(_detached(fake_params), _detached(self.gan_params), x0_gen, t,
                              cross_cond, nz)
        # non-saturating generator loss: -log sigmoid(logits)
        g_adv = F.softplus(-logits).mean()
        loss = dmd + self.gan_g_weight * g_adv
        return loss, {"dmd_loss": dmd, "gan_g_loss": g_adv}

    def critic_loss(self, fake_and_gan_params: Tuple[Params, Params], gen_params: Params,
                    noise: torch.Tensor, cross_cond, draws: Draws,
                    real_latent: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        fake_params, gan_params = fake_and_gan_params
        with torch.no_grad():
            x0_gen, _ = self.pipeline.inference_with_trajectory(gen_params, noise, cross_cond,
                                                                draws)
        t = self._gan_timesteps(x0_gen, draws)
        nz_fake = draws.normal(x0_gen.shape, x0_gen.dtype, x0_gen.device)
        fake_logits = self._logits(fake_params, gan_params, x0_gen, t, cross_cond, nz_fake)

        # the flow-matching critic loss keeps the fake score a valid score net
        # (its own rollout, after the draws above)
        base, _ = super().critic_loss(fake_params, gen_params, noise, cross_cond, draws)

        if real_latent is None:
            loss = base + self.gan_d_weight * F.softplus(fake_logits).mean()
            return loss, {"critic_loss": base}
        nz_real = draws.normal(real_latent.shape, real_latent.dtype, real_latent.device)
        real_logits = self._logits(fake_params, gan_params, real_latent, t, cross_cond, nz_real)
        if self.relativistic:
            d_adv = F.softplus(-(real_logits - fake_logits)).mean()
        else:
            d_adv = F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean()
        # R1 / R2: the logits' drift under small input perturbations, drawn
        # (as in the JAX code) from the same numbers as the logits' noise
        penalties = 0.0
        if self.r1_weight > 0:
            pert = real_latent + self.r1_sigma * nz_real
            pl = self._logits(fake_params, gan_params, pert, t, cross_cond, nz_real)
            penalties = penalties + self.r1_weight * ((real_logits - pl) ** 2).mean()
        if self.r2_weight > 0:
            pert = x0_gen + self.r2_sigma * nz_fake
            pl = self._logits(fake_params, gan_params, pert, t, cross_cond, nz_fake)
            penalties = penalties + self.r2_weight * ((fake_logits - pl) ** 2).mean()
        loss = base + self.gan_d_weight * d_adv + penalties
        return loss, {"critic_loss": base, "gan_d_loss": d_adv}
