"""L2 normalisation and the similarity measures (mirrors
aladin_tpu/ops/similarity.py)."""

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


def dot_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) raw inner products in f32."""
    return torch.matmul(im.float(), s.float().T)


def cosine_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inner products of the l2-normalised rows."""
    return dot_sim(l2norm(im), l2norm(s))


def order_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Order-embedding similarity -||max(0, s - im)||_2 as (n_im, n_s)."""
    diff = torch.clamp(s[:, None, :] - im[None, :, :], min=0.0)
    return (-torch.sqrt(torch.sum(torch.square(diff), dim=2))).T


SIMILARITIES = {"dot": dot_sim, "cosine": cosine_sim, "order": order_sim}


def get_similarity(measure: str):
    try:
        return SIMILARITIES[measure]
    except KeyError:
        raise ValueError(f"unknown measure {measure!r}; expected one of {sorted(SIMILARITIES)}")
