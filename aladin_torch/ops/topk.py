"""Top-k in ``jax.lax.top_k``'s order.

``lax.top_k`` returns the k largest entries of the last axis, largest
first, with equal values in index order (the lower index first).
``torch.topk`` on CUDA promises no order among equal values, and the
synthetic corpora repeat caption rows, so exact ties do occur: a stable
descending sort keeps the lower index first.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the ``k`` largest entries of the last
    axis, largest first, ties in index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
