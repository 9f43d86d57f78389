"""The int8 tier's quantisation arithmetic, in plain float32.

A quantised operand is held as its integer quanta times its scale. `qmax` is
127 for int8 (what the configurations state) and 7 for int4 (the control,
one precision step below). Rounding is half to even, divisions are f32
divisions, as the tier states them.

  * weights: one scale per output channel, amax / qmax over the input axis;
  * activations: one static scale per site, calibrated amax * 1.5 / qmax,
    the quanta clipped to [-qmax, qmax];
  * the int8 QK^T attention: q rows and k rows (k minus the mean of its
    `seg`-row segment, the zero padding of the last segment counted) each
    get their own scale amax / qmax + 1e-8, and the logits are the integer
    products times the two scales, in the log2 domain.
"""
from __future__ import annotations

import math

import torch

MARGIN = 1.5


def weight_quanta(w: torch.Tensor, qmax: int):
    """w [..., in, out] -> (quanta as f32 integers, scale [..., 1, out] f32)."""
    w = w.float()
    amax = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-8)
    scale = amax / torch.full_like(amax, float(qmax))  # an IEEE quotient
    return torch.clamp(torch.round(w / scale), -qmax, qmax), scale


def act_scale(amax: float, qmax: int) -> float:
    """A static activation scale from a calibrated amax (float64, as stated)."""
    return max(float(amax), 1e-6) * MARGIN / qmax


def fake_quant_act(x: torch.Tensor, scale: float, qmax: int) -> torch.Tensor:
    s = torch.full((), scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def quantize_rows(x: torch.Tensor, qmax: int):
    """Per-row (last axis) quanta and scales of x f32."""
    amax = x.abs().amax(-1, keepdim=True)
    s = amax / torch.full_like(amax, float(qmax)) + 1e-8
    return torch.round(x / s), s


def segment_rows(lk: int, bk: int = 1024) -> int:
    """The mean segment width of the int8 QK^T attention over lk keys."""
    return min(bk, -(-lk // 128) * 128)


def centred_keys(k: torch.Tensor, seg: int) -> torch.Tensor:
    """k [B, L, N, D] minus the mean of its seg-row segment (zero padded)."""
    b, lk, n, d = k.shape
    nseg = -(-lk // seg)
    kp = torch.cat([k, k.new_zeros((b, nseg * seg - lk, n, d))], 1)
    means = kp.reshape(b, nseg, seg, n, d).mean(dim=2)
    return k - means.repeat_interleave(seg, dim=1)[:, :lk]


LOG2E = 1.0 / math.log(2.0)
