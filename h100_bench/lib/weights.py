"""Random weights from the run's seed, made on the device in a few large
calls: one normal draw for every matrix and embedding table, split into
views; zeros for biases; ones for LayerNorm scales (the port's
``init_weights`` rule, applied by the benchmark itself).

A weight spec is a list of (name, shape) in a fixed order; the same spec,
seed and device give the same tensors, so a reference can make them again
after the program's state is gone."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from h100_bench.lib.traffic import generator

Spec = List[Tuple[str, Tuple[int, ...]]]


def kind(name: str, shape: Sequence[int]) -> str:
    """"normal" for matrices and tables, "one" for LayerNorm scales,
    "zero" for every other vector."""
    if len(shape) >= 2:
        return "normal"
    if ("LayerNorm" in name or "norm" in name) and name.endswith("weight"):
        return "one"
    return "zero"


def make(spec: Spec, seed: int, stream: int, device, std: float) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``spec``: the matrices from one normal
    draw of ``std`` on ``device`` (each a contiguous slice), the vectors
    filled."""
    gen = generator(seed, stream, device)
    sizes = [int(torch.Size(s).numel()) for n, s in spec if kind(n, s) == "normal"]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(std)
    pieces = iter(flat.split(sizes))
    out = {}
    for name, shape in spec:
        k = kind(name, shape)
        if k == "normal":
            out[name] = next(pieces).view(shape)
        elif k == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
