"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["device_context", "indexed_device", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card (``"cuda"``).  Asking for CUDA without a card
    raises: the port never falls back to the CPU on its own — callers that
    want the CPU (the tests) say ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def indexed_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` resolved (:func:`resolve_device`) with its index: a CUDA
    device without one is the current CUDA device, as a tensor's
    ``.device`` names it, so that the two compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_context(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device: kernel launches and
    CUDA-graph captures go to the current device, whatever device their
    tensors are on.  A no-op context for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
