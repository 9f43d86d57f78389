"""Flow-matching multistep ODE solvers for the 50-step teacher path (port of
realtime_video_tpu/solvers.py).

The reference's diffusers-style schedulers (wan/utils/fm_solvers.py
FlowDPMSolverMultistepScheduler, fm_solvers_unipc.py
FlowUniPCMultistepScheduler) in x0 (data) prediction form:

  * DPM-Solver++ multistep, orders 1-3 (midpoint second order), with the
    lower_order_final / final_sigmas_type="zero" step-order selection;
  * UniPC-bh2 predictor / corrector at any order (the reference's 0.5
    weights at orders 2 and 1), the order decaying at the tail.

Flow matching: x_t = (1 - s) x0 + s eps, alpha = 1 - s, sigma = s, lambda =
log(alpha / sigma), +-inf at the ends so that expm1(-inf) = -1 at the last
step. The schedule is host-side float64 numpy and Python floats, as in the
JAX package; only the updates touch tensors, each in the sample's dtype, and
the x0 history is a list of tensors on the sample's device.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _shifted_sigmas(num_inference_steps: int, shift: float,
                    num_train_timesteps: int = 1000) -> np.ndarray:
    """The set_timesteps ladder: linspace from the train grid's sigma_max
    (1 - 1/num_train_timesteps) down to 0, its last point dropped, then the
    shift transform and a trailing 0 (final_sigmas_type="zero")."""
    s = np.linspace(1.0 - 1.0 / num_train_timesteps, 0.0, num_inference_steps + 1,
                    dtype=np.float64)[:-1]
    s = shift * s / (1 + (shift - 1) * s)
    return np.concatenate([s, [0.0]])


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """linspace(1, 0, n + 1)[:n] through the shift transform: the explicit
    ladder the dpm++ pipelines pass to set_timesteps(sigmas=...)."""
    s = np.linspace(1.0, 0.0, sampling_steps + 1, dtype=np.float64)[:sampling_steps]
    return shift * s / (1 + (shift - 1) * s)


class _FlowSolverBase:
    """The schedule and the x0 history."""

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 5.0,
                 solver_order: int = 2, lower_order_final: bool = True):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.solver_order = solver_order
        self.lower_order_final = lower_order_final
        self.sigmas: Optional[np.ndarray] = None
        self.timesteps: Optional[np.ndarray] = None
        self._x0_history: List[torch.Tensor] = []
        self._step_index = 0
        self._lower_order_nums = 0

    def set_timesteps(self, num_inference_steps: int, shift: Optional[float] = None,
                      sigmas: Optional[Sequence[float]] = None):
        if shift is not None:
            self.shift = shift
        if sigmas is not None:
            self.sigmas = np.concatenate([np.asarray(sigmas, np.float64), [0.0]])
        else:
            self.sigmas = _shifted_sigmas(num_inference_steps, self.shift,
                                          self.num_train_timesteps)
        # the reference casts the timesteps to int64
        self.timesteps = (self.sigmas[:-1] * self.num_train_timesteps
                          ).astype(np.int64).astype(np.float32)
        self._x0_history = []
        self._step_index = 0
        self._lower_order_nums = 0

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    def _lam(self, i: int) -> float:
        s = float(self.sigmas[i])
        if s <= 0.0:
            return math.inf
        if s >= 1.0:
            return -math.inf
        return math.log((1 - s) / s)

    def _alpha_sigma(self, i: int) -> Tuple[float, float]:
        s = float(self.sigmas[i])
        return 1.0 - s, s

    def convert_flow_to_x0(self, flow_pred: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        sigma = float(self.sigmas[self._step_index])
        return sample - sigma * flow_pred

    def scale_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                    step_index: int) -> torch.Tensor:
        """(1 - sigma) sample + sigma noise at schedule index `step_index`."""
        s = float(self.sigmas[step_index])
        return (1 - s) * sample + s * noise

    def _push_history(self, x0: torch.Tensor) -> None:
        self._x0_history.append(x0)
        if len(self._x0_history) > self.solver_order:
            self._x0_history.pop(0)


class FlowDPMSolverMultistep(_FlowSolverBase):
    """DPM-Solver++ multistep, data prediction, orders 1-3."""

    def step(self, model_output_flow: torch.Tensor, timestep, sample: torch.Tensor):
        del timestep  # sequential stepping: the index is tracked here
        i = self._step_index
        n = self.num_steps
        x0 = self.convert_flow_to_x0(model_output_flow, sample)
        self._push_history(x0)

        # final_sigmas_type="zero" forces first order at the last step
        lower_final = i == n - 1
        lower_second = (i == n - 2) and self.lower_order_final and n < 15

        a_t, s_t = self._alpha_sigma(i + 1)
        _, s_s = self._alpha_sigma(i)
        h = self._lam(i + 1) - self._lam(i)
        em1 = math.expm1(-h)  # exp(-h) - 1, -1 at h = inf

        if self.solver_order == 1 or self._lower_order_nums < 1 or lower_final:
            x_t = (s_t / s_s) * sample - a_t * em1 * x0
        elif self.solver_order == 2 or self._lower_order_nums < 2 or lower_second:
            h0 = self._lam(i) - self._lam(i - 1)
            r0 = h0 / h
            m0, m1 = self._x0_history[-1], self._x0_history[-2]
            d1 = (m0 - m1) / r0 if math.isfinite(r0) else torch.zeros_like(m0)
            # midpoint, the reference's default solver_type
            x_t = (s_t / s_s) * sample - a_t * em1 * m0 - 0.5 * a_t * em1 * d1
        else:
            h0 = self._lam(i) - self._lam(i - 1)
            h1 = self._lam(i - 1) - self._lam(i - 2)
            r0, r1 = h0 / h, h1 / h
            m0, m1, m2 = self._x0_history[-1], self._x0_history[-2], self._x0_history[-3]
            d1_0 = (m0 - m1) / r0 if math.isfinite(r0) else torch.zeros_like(m0)
            d1_1 = (m1 - m2) / r1 if math.isfinite(r1) else torch.zeros_like(m0)
            rr = r0 / (r0 + r1) if math.isfinite(r0 + r1) else 0.0
            ss = 1.0 / (r0 + r1) if math.isfinite(r0 + r1) else 0.0
            d1 = d1_0 + rr * (d1_0 - d1_1)
            d2 = ss * (d1_0 - d1_1)
            x_t = ((s_t / s_s) * sample - a_t * em1 * m0
                   + a_t * (em1 / h + 1.0) * d1
                   - a_t * ((em1 + h) / h**2 - 0.5) * d2)

        if self._lower_order_nums < self.solver_order:
            self._lower_order_nums += 1
        self._step_index += 1
        return x_t.to(sample.dtype)


class FlowUniPCMultistep(_FlowSolverBase):
    """UniPC (bh2, data prediction) predictor / corrector at any order."""

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 5.0,
                 solver_order: int = 2, lower_order_final: bool = True,
                 disable_corrector: Sequence[int] = ()):
        super().__init__(num_train_timesteps, shift, solver_order, lower_order_final)
        self.disable_corrector = set(disable_corrector)
        self._last_sample: Optional[torch.Tensor] = None
        self._this_order = 1

    def set_timesteps(self, num_inference_steps: int, shift: Optional[float] = None,
                      sigmas: Optional[Sequence[float]] = None):
        super().set_timesteps(num_inference_steps, shift, sigmas)
        self._last_sample = None
        self._this_order = 1

    def _bh_coeffs(self, rks: List[float], h: float, order: int):
        """The bh2 variant's system: (R, b, h_phi_1, B_h)."""
        hh = -h
        h_phi_1 = math.expm1(hh)
        B_h = h_phi_1  # bh2
        h_phi_k = h_phi_1 / hh - 1.0
        rks_full = np.asarray(rks + [1.0], np.float64)
        R, b = [], []
        factorial_i = 1.0
        for k in range(1, order + 1):
            R.append(rks_full ** (k - 1))
            b.append(h_phi_k * factorial_i / B_h)
            factorial_i *= k + 1
            h_phi_k = h_phi_k / hh - 1.0 / factorial_i
        return np.stack(R), np.asarray(b, np.float64), h_phi_1, B_h

    def _uni_p(self, sample: torch.Tensor, order: int, i: int) -> torch.Tensor:
        m0 = self._x0_history[-1]
        a_t, s_t = self._alpha_sigma(i + 1)
        _, s_s0 = self._alpha_sigma(i)
        h = self._lam(i + 1) - self._lam(i)

        rks, d1s = [], []
        for k in range(1, order):
            rk = (self._lam(i - k) - self._lam(i)) / h
            rks.append(rk)
            d1s.append((self._x0_history[-(k + 1)] - m0) / rk)

        R, b, h_phi_1, B_h = self._bh_coeffs(rks, h, order)
        x_t = (s_t / s_s0) * sample - a_t * h_phi_1 * m0
        if d1s:
            if order == 2:
                rhos_p = np.asarray([0.5])  # the reference's simplification
            else:
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            pred = sum(float(r) * d for r, d in zip(rhos_p, d1s))
            x_t = x_t - a_t * B_h * pred
        return x_t

    def _uni_c(self, x0_t: torch.Tensor, last_sample: torch.Tensor, order: int,
               i: int) -> torch.Tensor:
        m0 = self._x0_history[-1]
        a_t, s_t = self._alpha_sigma(i)
        _, s_s0 = self._alpha_sigma(i - 1)
        h = self._lam(i) - self._lam(i - 1)

        rks, d1s = [], []
        for k in range(1, order):
            rk = (self._lam(i - 1 - k) - self._lam(i - 1)) / h
            rks.append(rk)
            d1s.append((self._x0_history[-(k + 1)] - m0) / rk)

        R, b, h_phi_1, B_h = self._bh_coeffs(rks, h, order)
        if order == 1:
            rhos_c = np.asarray([0.5])  # the reference's simplification
        else:
            rhos_c = np.linalg.solve(R, b)
        x_t = (s_t / s_s0) * last_sample - a_t * h_phi_1 * m0
        corr = sum(float(r) * d for r, d in zip(rhos_c[:-1], d1s))
        d1_t = x0_t - m0
        return x_t - a_t * B_h * (corr + float(rhos_c[-1]) * d1_t)

    def step(self, model_output_flow: torch.Tensor, timestep, sample: torch.Tensor):
        del timestep
        i = self._step_index
        n = self.num_steps
        x0 = self.convert_flow_to_x0(model_output_flow, sample)

        if i > 0 and (i - 1) not in self.disable_corrector and self._last_sample is not None:
            sample = self._uni_c(x0, self._last_sample, self._this_order, i).to(sample.dtype)

        self._push_history(x0)

        this_order = min(self.solver_order, n - i) if self.lower_order_final \
            else self.solver_order
        self._this_order = min(this_order, self._lower_order_nums + 1)

        self._last_sample = sample
        x_t = self._uni_p(sample, self._this_order, i)

        if self._lower_order_nums < self.solver_order:
            self._lower_order_nums += 1
        self._step_index += 1
        return x_t.to(sample.dtype)


def make_solver(name: str, sampling_steps: int, shift: float):
    """A solver with its timesteps set as the JAX pipelines set them: unipc
    on its own ladder; dpm++ on the explicit `get_sampling_sigmas` ladder."""
    if name == "unipc":
        solver = FlowUniPCMultistep(shift=shift)
        solver.set_timesteps(sampling_steps, shift=shift)
    elif name in ("dpm++", "dpm-solver", "dpm"):
        solver = FlowDPMSolverMultistep(shift=shift)
        solver.set_timesteps(sampling_steps, shift=shift,
                             sigmas=get_sampling_sigmas(sampling_steps, shift))
    else:
        raise NotImplementedError(f"unsupported solver {name!r}")
    return solver
