"""The random draws of a training step.

The JAX package splits a `jax.random` key; the port draws from
`torch.Generator`s. The two give different numbers, so every loss and the
rollout take a `Draws` object and make their draws through it in the order
the JAX code makes its `jax.random.normal` / `randint` calls: a test can
then replay JAX's draws one for one (`ReplayDraws` in the tests), and a
training run uses `TorchDraws`.
"""
from __future__ import annotations

from typing import Protocol, Tuple

import torch


class Draws(Protocol):
    def normal(self, shape: Tuple[int, ...], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
        """Standard-normal draws, made in f32 and cast to `dtype`."""

    def randint(self, low: int, high: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """Integers in [low, high), int64 on the CPU (host-side control flow
        and timesteps read them)."""


class TorchDraws:
    """Draws from two generators seeded with `seed`: normals on `device`,
    integers on the CPU."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._normal = torch.Generator(device=self.device).manual_seed(seed)
        self._int = torch.Generator().manual_seed(seed)

    def normal(self, shape, dtype, device) -> torch.Tensor:
        out = torch.randn(tuple(shape), generator=self._normal, dtype=torch.float32,
                          device=self.device)
        return out.to(device=device, dtype=dtype)

    def randint(self, low, high, shape) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self._int)


class DataParallelDraws:
    """A dp rank's share of the draws of the whole batch: each draw is made
    at dp x the local leading (batch) size from `draws`, in its order, and
    this rank keeps its rows. Every rank of the step then sees what one
    device drawing the whole batch sees (the JAX step draws the whole
    sharded batch from one key)."""

    def __init__(self, draws: Draws, dp: int, rank: int):
        self.draws, self.dp, self.rank = draws, dp, rank

    def _rows(self, x: torch.Tensor, b: int) -> torch.Tensor:
        return x[self.rank * b:(self.rank + 1) * b]

    def normal(self, shape, dtype, device) -> torch.Tensor:
        b = shape[0]
        return self._rows(self.draws.normal((b * self.dp, *shape[1:]), dtype, device), b)

    def randint(self, low, high, shape) -> torch.Tensor:
        b = shape[0]
        return self._rows(self.draws.randint(low, high, (b * self.dp, *shape[1:])), b)
