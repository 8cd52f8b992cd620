"""The general generator: sizes and orders drawn from a traffic file's
parameters and the run's seed.

Every seed gets the same multiset of sizes, in another order, so that runs
with different seeds do the same work. A length distribution in a traffic
file is one of

  * ``{"fixed": n}``;
  * ``{"choice": [[value, weight], ...]}``: each value gets its share of
    the n draws (largest remainders break rounding);
  * ``{"gamma": {"shape": k, "scale": s, "shift": a, "min": lo, "max": hi}}``:
    round(a + Gamma(k, s)) clipped to [lo, hi], as a ``choice`` of its
    probabilities;
  * ``{"uniform": [lo, hi]}``: integers lo..hi inclusive, evenly spread.

The multiset is then permuted by a generator seeded from the run's seed.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """The seed of one named stream of the run."""
    return (int(seed) * 1_000_003 + stream * 7919 + 12345) & SEED_MASK


def generator(seed: int, stream: int, device="cpu") -> torch.Generator:
    """A torch generator on ``device`` for one named stream of the run:
    the same (seed, stream) always gives the same draws."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def _gamma_cdf(x: float, k: float) -> float:
    """The regularised lower incomplete gamma function P(k, x) (series)."""
    if x <= 0:
        return 0.0
    term = total = 1.0 / k
    for j in range(1, 2000):
        term *= x / (k + j)
        total += term
        if term < 1e-15 * total:
            break
    return min(1.0, total * math.exp(-x + k * math.log(x) - math.lgamma(k)))


def _gamma_weights(g: Dict) -> list:
    """[[value, probability], ...] of round(shift + Gamma(shape, scale))
    clipped to [min, max]: the mass below min goes to min, above max to max."""
    k, scale, shift = float(g["shape"]), float(g["scale"]), float(g.get("shift", 0))
    lo, hi = int(g["min"]), int(g["max"])
    cdf = [_gamma_cdf((v + 0.5 - shift) / scale, k) for v in range(lo, hi)] + [1.0]
    return [[lo + i, c - (cdf[i - 1] if i else 0.0)] for i, c in enumerate(cdf)]


def multiset(spec: Dict, n: int) -> np.ndarray:
    """The n sizes of ``spec`` in ascending order (see the module doc)."""
    if "fixed" in spec:
        return np.full(n, int(spec["fixed"]), np.int64)
    if "uniform" in spec:
        lo, hi = (int(v) for v in spec["uniform"])
        return np.sort(lo + (np.arange(n) * (hi - lo + 1)) // n).astype(np.int64)
    if "choice" in spec:
        values = np.array([int(v) for v, _ in spec["choice"]], np.int64)
        weights = np.array([float(w) for _, w in spec["choice"]])
        share = weights / weights.sum() * n
        counts = np.floor(share).astype(np.int64)
        for i in np.argsort(-(share - counts), kind="stable")[: n - counts.sum()]:
            counts[i] += 1
        return np.sort(np.repeat(values, counts))
    if "gamma" in spec:
        return multiset({"choice": _gamma_weights(spec["gamma"])}, n)
    raise ValueError(f"unknown length distribution {spec!r}")


def lengths(spec: Dict, n: int, seed: int, stream: int) -> np.ndarray:
    """The multiset of ``spec`` permuted by the run's seed."""
    perm = torch.randperm(n, generator=generator(seed, stream)).numpy()
    return multiset(spec, n)[perm]


def permutation(n: int, seed: int, stream: int) -> np.ndarray:
    return torch.randperm(n, generator=generator(seed, stream)).numpy()
