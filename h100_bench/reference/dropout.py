"""The training step's dropout masks, drawn as the program draws them, so
that the plain reference follows a step with dropout on.

Every mask comes from the run's seed (``lib/traffic.py::stream_seed``),
which the benchmark puts into the generators right before the program's
first step; the reference puts the same seed in again and then draws in
the program's order:

  * the plain dropouts (embeddings, regions, each sublayer's output, the
    matching head's) with torch's own dropout, on a tensor of the same
    shape and type as the program's at that point: the compute type,
    float32 after a LayerNorm (autocast keeps LayerNorm in float32). A
    mask drawn so is the program's, since the same generator state, shape
    and type launch the same kernel with the same Philox offsets, also
    inside a CUDA graph (a replay starts at the generator's offset and
    advances it by what the captured steps draw);
  * the fused attention's per-layer seeds, one randint of ``layers``
    values a backbone pass after its embeddings: on the card from the
    default CUDA generator, on the CPU from the backbone's own generator;
  * the fused attention's keep bits, from a frozen copy of the kernel's
    counter-based hash (``csrc/attention_kernel.cu::mix32``): element
    (b, h, q, k) is kept when
    mix32(mix32(mix32(seed) ^ (b * H + h)) ^ (q * S + k)) >= uint32(rate * 2^32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _mul32(x, m: int):
    """(x * m) mod 2^32 for int64 x in [0, 2^32), m split in 16-bit halves."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def attention_keep(seed: torch.Tensor, b: int, h: int, s: int, rate: float) -> torch.Tensor:
    """(B, H, S, S) bool keep bits of the fused attention's ``seed`` (a
    one-element int64 tensor)."""
    dev = seed.device
    bh = (torch.arange(b, device=dev, dtype=torch.int64).reshape(b, 1, 1, 1) * h
          + torch.arange(h, device=dev, dtype=torch.int64).reshape(1, h, 1, 1))
    qk = torch.arange(s * s, device=dev, dtype=torch.int64).reshape(1, 1, s, s)
    key = mix32(mix32(seed.to(torch.int64).reshape(()) & M32) ^ bh)
    return mix32(key ^ qk) >= min(int(rate * 2 ** 32), M32)


class Dropouts:
    """The masks of one training run from ``seed``: ``hidden`` (rate
    ``residual_dropout``), ``attention`` (``attention_dropout``) and
    ``matching`` (``matching_dropout``) as the configuration states them.
    Making one puts ``seed`` into the generators the program draws from."""

    def __init__(self, c: dict, seed: int, device):
        device = torch.device(device)
        self.hidden = c["residual_dropout"]
        self.attention = c["attention_dropout"]
        self.matching = c["matching_dropout"]
        if self.attention > 0.0 and not c["fused_attention"]:
            raise ValueError("the reference follows the fused attention's dropout only")
        self.dtype = DTYPES[c["compute_dtype"]]
        self.device = device
        if device.type == "cuda":
            torch.cuda.manual_seed(seed)
            self.seed_gen = None
        else:
            torch.manual_seed(seed)
            self.seed_gen = torch.Generator().manual_seed(seed)

    def apply(self, x: torch.Tensor, rate: float, after_layernorm: bool = False) -> torch.Tensor:
        """``x`` dropped by the mask the program draws next for a tensor of
        x's shape (float32 after a LayerNorm, else the compute type)."""
        if rate <= 0.0:
            return x
        dtype = torch.float32 if after_layernorm else self.dtype
        keep = F.dropout(torch.ones(x.shape, dtype=dtype, device=x.device), rate) != 0
        return x * keep / (1.0 - rate)

    def attention_seeds(self, layers: int):
        """The fused attention's seeds of one backbone pass, or None where
        the program draws none."""
        if self.attention <= 0.0:
            return None
        if self.device.type == "cuda":
            return torch.randint(0, 2 ** 31 - 1, (layers,), device=self.device)
        return torch.randint(0, 2 ** 31 - 1, (layers,), generator=self.seed_gen)

    def attention_probs(self, probs: torch.Tensor, seed) -> torch.Tensor:
        """Backbone attention probabilities (B, H, S, S) dropped by the fused
        kernel's keep bits under ``seed``."""
        if self.attention <= 0.0:
            return probs
        b, h, s, _ = probs.shape
        keep = attention_keep(seed, b, h, s, self.attention)
        return probs * keep / (1.0 - self.attention)
