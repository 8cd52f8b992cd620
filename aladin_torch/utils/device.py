"""Device selection for the port's entry points, and CUDA graph capture."""

from __future__ import annotations

import contextlib
import gc

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


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph", **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` with Python's cyclic garbage
    collector paused: a collection inside the capture can finalize garbage
    left by earlier work (an autograd checkpoint's hooks, another CUDA
    graph's reset) with calls a capturing stream does not permit, which
    invalidates the capture. The garbage is collected after it instead."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
    finally:
        if enabled:
            gc.enable()
