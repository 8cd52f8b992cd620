"""The yardstick's arithmetic: the card's peaks, roofline bounds and model
FLOPs counted from shapes.

Copied from the port's sources so that a later change to the program cannot
move the yardstick: ``mrsw_bound``, ``bound`` and ``attention_bound`` from
``chip_smoke.py``; ``transformer_layer_flops`` and ``train_step_model_flops``
from ``aladin_torch/utils/profiling.py``. ``caption_decode_flops`` is the
benchmark's own count of the KV-cached greedy decoder's matmul work.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense rates.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(n_bytes: float, ops: float, peak: str) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the larger of bytes over HBM
    bandwidth and operations over the ``peak`` rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[peak]
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops else "operations")


def attention_bound(b: int, s: int, h: int, d: int, q_dim: int, backward: bool) -> Tuple[float, str]:
    """K2's least time in seconds: 4 (forward) or 10 (backward) x B*H*S^2*d
    operations at the bf16 peak, against q, k, v (and g) read and ctx (dq,
    dk, dv) written once in bf16 plus the f32 bias read once (``q_dim`` 1
    for a 1-D key mask, S for a 2-D one)."""
    ops = (10.0 if backward else 4.0) * b * h * s * s * d
    n_bytes = (7 if backward else 4) * b * s * h * d * 2 + b * q_dim * s * 4
    return bound(n_bytes, ops, "bf16")


def mrsw_valid_ops(d: int, im_len: Sequence[int], cap_len: Sequence[int]) -> float:
    """Operations the MrSw scores of these inputs need: valid regions (the
    special slot stripped) x valid words (CLS and the last two slots
    stripped) x D x 2, over all pairs."""
    regions = float(sum(max(int(n) - 1, 0) for n in im_len))
    words = float(sum(max(int(n) - 3, 0) for n in cap_len))
    return 2.0 * d * regions * words


def mrsw_bound(n_im: int, r: int, n_cap: int, w: int, d: int, im_len: Sequence[int],
               cap_len: Sequence[int], dtype: str = "bf16") -> Tuple[float, str]:
    """K1's least time in seconds on these inputs: operand bytes read once
    plus the f32 output written once over HBM bandwidth, or the valid
    operations over the tensor-core peak, whichever is larger."""
    elem = 1 if dtype == "int8" else 2
    n_bytes = (n_im * (r - 1) + n_cap * (w - 3)) * d * elem + n_im * n_cap * 4
    return bound(n_bytes, mrsw_valid_ops(d, im_len, cap_len), dtype)


def transformer_layer_flops(seq: int, d_model: int, d_ff: int) -> float:
    """Forward matmul FLOPs of one post-LN encoder layer for one sequence:
    QKV + output projections 4 * 2*S*d^2, scores + mixing 2 * 2*S^2*d, FFN
    2 * 2*S*d*d_ff."""
    return 8 * seq * d_model ** 2 + 4 * seq ** 2 * d_model + 4 * seq * d_model * d_ff


def train_step_model_flops(batch: int, text_len: int = 50, img_text_len: int = 50,
                           n_regions: int = 34, hidden: int = 768, n_layers: int = 12,
                           intermediate: int = 3072, img_feature_dim: int = 2054,
                           tern_layers: int = 2, alignment: bool = True) -> float:
    """Model FLOPs of one ALADIN train step (forward + 2x backward, no
    recompute): the caption pass at text_len, the image pass at img_text_len
    + n_regions with the region projection, the matching head's TE over both
    token sets, the B^2 * R * W * d alignment tensor (specials stripped) and
    the B^2 global products."""
    s_img = img_text_len + n_regions
    fwd = 0.0
    for s in (text_len, s_img):
        fwd += batch * n_layers * transformer_layer_flops(s, hidden, intermediate)
    fwd += batch * 2 * n_regions * img_feature_dim * hidden
    for s in (text_len, s_img):
        fwd += batch * tern_layers * transformer_layer_flops(s, hidden, hidden)
    if alignment:
        fwd += 2 * batch * batch * (n_regions - 1) * (text_len - 3) * hidden
    fwd += 2 * batch * batch * hidden
    return 3.0 * fwd


def caption_decode_flops(context_len: Sequence[int], n_regions: Sequence[int], steps: int,
                         hidden: int, layers: int, intermediate: int, vocab: int,
                         img_feature_dim: int) -> float:
    """Matmul FLOPs that KV-cached greedy decoding of one batch needs.

    ``context_len[i]``: image i's valid OD-label tokens plus regions;
    ``n_regions[i]``: its valid regions. The prefill runs each context
    token through every layer (projections, FFN, attention over the valid
    context) and projects the regions; each of ``steps`` steps runs two
    tokens through every layer, attending over the valid context, the
    caption slots written so far and the two in-flight tokens, and the MLM
    head (transform and tied decoder) on one row."""
    per_token_linear = 2.0 * (4 * hidden * hidden + 2 * hidden * intermediate)
    total = 0.0
    for c, r in zip(context_len, n_regions):
        total += 2.0 * r * img_feature_dim * hidden
        total += layers * c * (per_token_linear + 4.0 * c * hidden)
        for t in range(1, steps + 1):
            keys = c + (t - 1) + 2
            total += layers * 2 * (per_token_linear + 4.0 * keys * hidden)
            total += 2.0 * hidden * hidden + 2.0 * hidden * vocab
    return total
