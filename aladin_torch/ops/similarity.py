"""L2 normalisation (mirrors aladin_tpu/ops/similarity.py::l2norm)."""

from __future__ import annotations

import torch


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2-normalise along ``dim``.

    With ``eps=0`` this is the reference's bare division (the global
    embeddings); ``eps>0`` clamps the norm as torch's F.normalize does
    (1e-12 for token sets).
    """
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    if eps:
        norm = torch.clamp(norm, min=eps)
    return x / norm
