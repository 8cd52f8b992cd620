"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``name`` as a torch.device. A CUDA device must exist: entry points
    never carry on quietly on the CPU unless the caller asked for it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is available; "
            "pass --device cpu (or device='cpu') to run on the CPU")
    return device
