"""Length -> mask helpers (mirrors aladin_tpu/ops/masking.py).

Convention: ``True`` marks a VALID position; ``padding_mask`` is its inverse,
the ``src_key_padding_mask`` sense of torch.
"""

from __future__ import annotations

import torch


def valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool, True where position < length."""
    pos = torch.arange(max_len, device=lengths.device, dtype=torch.int32)
    return pos[None, :] < lengths[:, None].to(torch.int32)


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True where position is padding (torch ``src_key_padding_mask`` sense)."""
    return ~valid_mask(lengths, max_len)


def additive_attention_bias(mask: torch.Tensor, dtype=torch.float32,
                            neg: float = -10000.0) -> torch.Tensor:
    """1/0 attention mask -> additive bias ``(1 - mask) * neg``, broadcastable
    to (B, H, Q, K). Accepts a (B, K) 1-D mask or a (B, Q, K) 2-D block mask
    and inserts the head axis."""
    m = mask.to(dtype)
    if m.ndim == 2:
        m = m[:, None, None, :]
    elif m.ndim == 3:
        m = m[:, None, :, :]
    else:
        raise ValueError(f"attention mask must be 2-D or 3-D, got {m.ndim}-D")
    return (1.0 - m) * neg
