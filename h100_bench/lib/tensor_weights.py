"""Random weights made tensor by tensor, for models too large to draw in
one call (``lib/weights.py`` draws every matrix of a spec in one float32
tensor: 64 GB for a 16-billion-parameter model).

Tensor i of a spec is drawn from its own generator stream, (seed,
``STREAM0 + i``), in float32 on the device, scaled, and rounded to the
model's dtype; the caller copies it into place and drops it, so no second
full copy of the model is ever held. A reference that asks for some names
gets the same rounded values again, upcast to float32.

Kinds: matrices normal(0, ``std``); vectors named ``*correction_bias``
normal(0, ``bias_std``); every other vector (a norm's scale) ones. Every
tensor is drawn independently of the others.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Tuple

import torch

from h100_bench.lib.traffic import generator

STREAM0 = 1000  # tensor i draws from stream STREAM0 + i, past the run's named streams

Spec = Sequence[Tuple[str, Tuple[int, ...]]]


def _normal(seed: int, stream: int, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator(seed, stream, device), device=device,
                       dtype=torch.float32)


def tensors(spec: Spec, seed: int, device, dtype: torch.dtype, std: float, bias_std: float,
            names: Optional[Iterable[str]] = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every entry of ``spec``, or of ``names`` only, one
    at a time (module doc)."""
    wanted = None if names is None else set(names)
    for i, (name, shape) in enumerate(spec):
        if wanted is not None and name not in wanted:
            continue
        if len(shape) < 2 and not name.endswith("correction_bias"):
            yield name, torch.ones(shape, device=device, dtype=dtype)
            continue
        x = _normal(seed, STREAM0 + i, shape, device)
        yield name, x.mul_(std if len(shape) >= 2 else bias_std).to(dtype)
