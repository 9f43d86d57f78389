"""Where the port's entry points build their models."""
from __future__ import annotations

import contextlib

import torch


def indexed(device) -> torch.device:
    """`device` as a torch.device, a bare "cuda" given the current card's
    index: torch.device("cuda") != torch.device("cuda:0"), and placement
    checks compare devices."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device=None) -> torch.device:
    """`device` when the caller names one, else the current CUDA card, with
    its index. A host without a card raises: the CPU is used only when the
    caller asks for it."""
    if device is not None:
        return indexed(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return indexed("cuda")


def on_card(t: torch.Tensor):
    """The context a kernel binding launches in: t's card made current, for
    the .cu side sets attributes on, and counts SMs of, the current device.
    Where that card is current already, as on one card, a no-op context:
    entering `torch.cuda.device` at every launch costs more host time than
    the check (the `device_guard` phase of chip_smoke.py times both)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
