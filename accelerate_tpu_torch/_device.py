"""Explicit device selection: the port runs on the card unless asked for
the CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`. ``None`` means ``"cuda"``.
    Raises ``RuntimeError`` for a CUDA device when no GPU is present, so an
    entry point can never carry on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; expected 'cuda' or 'cpu'")
    return dev
