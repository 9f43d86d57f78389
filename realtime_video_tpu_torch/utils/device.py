"""Where the port's entry points build their models."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` when the caller names one, else the first CUDA card. A host
    without a card raises: the CPU is used only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return torch.device("cuda")
