"""Flow-matching noise schedule in PyTorch (port of realtime_video_tpu/scheduler.py).

    sigma schedule:   sigma = shift * s / (1 + (shift - 1) * s),  s = linspace
    timesteps:        t = sigma * num_train_timesteps
    add_noise:        x_t = (1 - sigma_t) * x0 + sigma_t * noise
    flow target:      v = noise - x0
    flow -> x0:       x0 = x_t - sigma_t * v
    euler step:       x_{t-1} = x_t + v * (sigma_next - sigma_t)

Timesteps are looked up by nearest neighbour (argmin |timesteps - t|), as in
the reference. Tables are built in numpy float32 exactly as the JAX package
builds them and live on the device the schedule was created for.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    sigmas: torch.Tensor  # [num_steps] f32
    timesteps: torch.Tensor  # [num_steps] f32
    num_train_timesteps: int = 1000
    shift: float = 5.0

    @classmethod
    def create(
        cls,
        num_inference_steps: int = 1000,
        num_train_timesteps: int = 1000,
        shift: float = 5.0,
        sigma_max: float = 1.0,
        sigma_min: float = 0.0,
        extra_one_step: bool = True,
        denoising_strength: float = 1.0,
        device=None,
    ) -> "FlowMatchSchedule":
        sigma_start = sigma_min + (sigma_max - sigma_min) * denoising_strength
        if extra_one_step:
            sigmas = np.linspace(
                sigma_start, sigma_min, num_inference_steps + 1, dtype=np.float32
            )[:-1]
        else:
            sigmas = np.linspace(
                sigma_start, sigma_min, num_inference_steps, dtype=np.float32
            )
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        timesteps = sigmas * num_train_timesteps
        return cls(
            sigmas=torch.as_tensor(sigmas, dtype=torch.float32, device=device),
            timesteps=torch.as_tensor(timesteps, dtype=torch.float32, device=device),
            num_train_timesteps=num_train_timesteps,
            shift=shift,
        )

    def timestep_id(self, timestep: torch.Tensor) -> torch.Tensor:
        """Nearest schedule index for (possibly fractional) timesteps [*]."""
        t = timestep.to(torch.float32)
        return torch.argmin(
            (self.timesteps[None, :] - t.reshape(-1)[:, None]).abs(), dim=1
        ).reshape(t.shape)

    def sigma_at(self, timestep: torch.Tensor) -> torch.Tensor:
        return self.sigmas[self.timestep_id(timestep)]

    def _bcast_sigma(self, timestep: torch.Tensor, ndim: int) -> torch.Tensor:
        sigma = self.sigma_at(timestep)
        return sigma.reshape(sigma.shape + (1,) * (ndim - sigma.dim()))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timestep: torch.Tensor) -> torch.Tensor:
        """x_t = (1 - sigma) x0 + sigma noise, in f32, cast to noise.dtype."""
        sigma = self._bcast_sigma(timestep, x0.dim())
        out = (1.0 - sigma) * x0.float() + sigma * noise.float()
        return out.to(noise.dtype)

    def step(self, model_output: torch.Tensor, timestep: torch.Tensor,
             sample: torch.Tensor, to_final: bool = False) -> torch.Tensor:
        """Euler flow step x + v (sigma_next - sigma) (scheduler.py:143-157),
        in f32, cast to sample.dtype; sigma_next is 0 past the last index and
        with `to_final`."""
        tid = self.timestep_id(timestep)
        sigma = self.sigmas[tid]
        sigma = sigma.reshape(sigma.shape + (1,) * (sample.dim() - sigma.dim()))
        n = self.sigmas.shape[0]
        if to_final:
            sigma_next = torch.zeros_like(sigma)
        else:
            nxt = self.sigmas[(tid + 1).clamp(max=n - 1)]
            sigma_next = torch.where(tid + 1 >= n, torch.zeros_like(nxt), nxt)
            sigma_next = sigma_next.reshape(sigma.shape)
        out = sample.float() + model_output.float() * (sigma_next - sigma)
        return out.to(sample.dtype)

    def flow_to_x0(self, flow_pred: torch.Tensor, xt: torch.Tensor,
                   timestep: torch.Tensor) -> torch.Tensor:
        """x0 = x_t - sigma_t * v, in f32, cast to flow_pred.dtype."""
        sigma = self._bcast_sigma(timestep, xt.dim())
        out = xt.float() - sigma * flow_pred.float()
        return out.to(flow_pred.dtype)

    def x0_to_flow(self, x0_pred: torch.Tensor, xt: torch.Tensor,
                   timestep: torch.Tensor) -> torch.Tensor:
        """v = (x_t - x0) / sigma_t (wan_wrapper.py:207-228), in f32, cast to
        x0_pred.dtype."""
        sigma = self._bcast_sigma(timestep, xt.dim())
        return ((xt.float() - x0_pred.float()) / sigma).to(x0_pred.dtype)

    def x0_to_noise(self, x0: torch.Tensor, xt: torch.Tensor,
                    timestep: torch.Tensor) -> torch.Tensor:
        """noise = (x_t - (1 - sigma) x0) / sigma, in f32, cast to x0.dtype."""
        sigma = self._bcast_sigma(timestep, xt.dim())
        return ((xt.float() - (1.0 - sigma) * x0.float()) / sigma).to(x0.dtype)

    def noise_to_x0(self, noise: torch.Tensor, xt: torch.Tensor,
                    timestep: torch.Tensor) -> torch.Tensor:
        """x0 = (x_t - sigma noise) / (1 - sigma), in f32, cast to noise.dtype."""
        sigma = self._bcast_sigma(timestep, xt.dim())
        return ((xt.float() - sigma * noise.float()) / (1.0 - sigma)).to(noise.dtype)

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timestep: torch.Tensor) -> torch.Tensor:
        """Flow-matching target v = noise - x0 (scheduler.py:178-180)."""
        del timestep
        return noise - sample

    def training_weight(self, timestep: torch.Tensor) -> torch.Tensor:
        """Gaussian-bell step weights at the nearest schedule step
        (scheduler.py:134-141, training=True), f32."""
        n = self.timesteps.shape[0]
        y = torch.exp(-2.0 * ((self.timesteps - n / 2) / n) ** 2)
        y_shifted = y - y.min()
        weights = y_shifted * (n / y_shifted.sum())
        return weights[self.timestep_id(timestep.to(self.timesteps.device))]

    def zero_padded_timesteps(self) -> torch.Tensor:
        """Timesteps with a trailing 0, for the denoising-schedule lookup."""
        return torch.cat([self.timesteps, self.timesteps.new_zeros(1)])


def get_denoising_schedule(zero_padded_timesteps, denoising_strength: float,
                           steps: int = 4) -> np.ndarray:
    """Strength-scaled denoising timestep list (reference v2v.py:133-136), a
    host-side float32 array of `steps` timesteps."""
    if isinstance(zero_padded_timesteps, torch.Tensor):
        zero_padded_timesteps = zero_padded_timesteps.cpu().numpy()
    tbl = np.asarray(zero_padded_timesteps)
    idx = np.linspace(denoising_strength * 1000, 0, steps, dtype=np.float32).astype(
        np.int64
    )
    return tbl[1000 - idx]


def warp_denoising_steps(timesteps, denoising_step_list) -> np.ndarray:
    """Integer steps warped through the shifted schedule
    (reference pipeline/causal_inference.py:29-32): a host-side float32 array."""
    if isinstance(timesteps, torch.Tensor):
        timesteps = timesteps.cpu().numpy()
    tbl = np.concatenate([np.asarray(timesteps, np.float32), np.zeros(1, np.float32)])
    return tbl[1000 - np.asarray(denoising_step_list, np.int64)]
