"""3D rotary position embeddings for the Wan DiT (port of
realtime_video_tpu/models/rope.py).

Per-axis angle tables (theta 10000) are built in float64 on the host and
stored as float32, split over the head dim as [t | h | w] =
[d - 4*(d//6), 2*(d//6), 2*(d//6)]; the temporal table is offset by the block's
start frame so cached frames keep absolute positions. Rotation runs in float32
on interleaved pairs (x[2i], x[2i+1]). RIFLEx (`riflex_k`, causal_model.py:26-38)
pins one temporal frequency for long-video extrapolation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _angle_table(max_seq_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Angles [max_seq_len, dim//2] = pos * theta^(-2i/dim)."""
    assert dim % 2 == 0
    inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
    return np.outer(np.arange(max_seq_len, dtype=np.float64), inv)


def _angle_table_riflex(max_seq_len: int, dim: int, theta: float = 10000.0, k: int = 0,
                        L_test: Optional[int] = None) -> np.ndarray:
    """The RIFLEx table: intrinsic frequency k-1 pinned to 0.9 * 2 pi / L_test
    (causal_model.py:26-38), in host float64."""
    inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
    if k:
        inv[k - 1] = 0.9 * 2 * np.pi / L_test
    return np.outer(np.arange(max_seq_len, dtype=np.float64), inv)


@dataclasses.dataclass(frozen=True)
class RopeTables:
    cos_t: torch.Tensor  # [max_seq, ct]
    sin_t: torch.Tensor
    cos_h: torch.Tensor  # [max_seq, ch]
    sin_h: torch.Tensor
    cos_w: torch.Tensor  # [max_seq, cw]
    sin_w: torch.Tensor

    @classmethod
    def create(cls, head_dim: int, max_seq_len: int = 1024, theta: float = 10000.0,
               riflex_k: int = 0, riflex_L_test: Optional[int] = None,
               device=None) -> "RopeTables":
        d = head_dim
        dt, dh, dw = d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6)
        if riflex_k:
            at = _angle_table_riflex(max_seq_len, dt, theta, riflex_k, riflex_L_test)
        else:
            at = _angle_table(max_seq_len, dt, theta)
        ah = _angle_table(max_seq_len, dh, theta)
        aw = _angle_table(max_seq_len, dw, theta)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return cls(
            cos_t=f32(np.cos(at)), sin_t=f32(np.sin(at)),
            cos_h=f32(np.cos(ah)), sin_h=f32(np.sin(ah)),
            cos_w=f32(np.cos(aw)), sin_w=f32(np.sin(aw)),
        )

    def fused(self, f: int, h: int, w: int,
              start_frame: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin), each [f*h*w, head_dim//2], for an (f, h, w) grid whose
        first frame sits at absolute position `start_frame`."""

        def grid(tab_t, tab_h, tab_w):
            tt = tab_t[start_frame:start_frame + f]
            gt = tt[:, None, None, :].expand(f, h, w, tt.shape[-1])
            gh = tab_h[None, :h, None, :].expand(f, h, w, tab_h.shape[-1])
            gw = tab_w[None, None, :w, :].expand(f, h, w, tab_w.shape[-1])
            return torch.cat([gt, gh, gw], dim=-1).reshape(f * h * w, -1)

        return (grid(self.cos_t, self.cos_h, self.cos_w),
                grid(self.sin_t, self.sin_h, self.sin_w))


def rope_apply_fused(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k [B, L, N, D] by precomputed (cos, sin) [L, D//2], in f32."""
    b, L, n, d = x.shape
    xf = x.float().reshape(b, L, n, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(b, L, n, d).to(x.dtype)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[*, dim] = [cos(p * 10000^(-i/half)) | sin(...)] (model.py:15-24), f32."""
    assert dim % 2 == 0
    half = dim // 2
    p = position.to(torch.float32).reshape(-1)
    # a Python scalar base: a 0-d tensor built on a card would copy from the
    # host and wait for the card's queue at every forward
    inv = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=p.device) / half)
    sinusoid = p[:, None] * inv[None, :]
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)
