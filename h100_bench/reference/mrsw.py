"""Plain PyTorch MrSw scoring and recall, written from ALADIN's alignment
head (``alad/loss.py``, aggregation MrSw) and the COCO retrieval protocol.

score(i, c) = sum over caption c's valid words of the max over image i's
valid regions of <region, word>, after l2-normalising every vector (norm
floored at 1e-12) and stripping the special tokens: an image's first slot,
a caption's first and last two slots (lengths shrink by 1 and 3).
Recall: an image's rank is the best rank among its captions, a caption's
the rank of its image, each the count of strictly greater scores.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from h100_bench.reference.precision import Precision


def prepare(sets: torch.Tensor, lens: torch.Tensor, strip_front: int, strip_back: int,
            normalize: bool = True):
    x = sets.float()
    if normalize:
        x = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    x = x[:, strip_front:x.shape[1] - strip_back]
    n = lens.long() - strip_front - strip_back
    return x * (torch.arange(x.shape[1], device=x.device)[None, :] < n[:, None])[..., None]


@torch.no_grad()
def scores(ims: torch.Tensor, il: torch.Tensor, caps: torch.Tensor, cl: torch.Tensor,
           prec: Precision, block_elems: int = 1 << 28,
           images_normalized: bool = False) -> torch.Tensor:
    """(N_im, N_cap) MrSw scores in blocks of captions, each block's
    alignment tensor at most ``block_elems`` f32 values
    (``images_normalized``: the image sets are stored normalised already,
    as an index keeps them)."""
    im = prepare(ims, il, 1, 0, normalize=not images_normalized)
    cap = prepare(caps, cl, 1, 2)
    n_im, r, d = im.shape
    block = max(1, block_elems // (n_im * r * cap.shape[1]))
    out = []
    with prec.context():
        for lo in range(0, cap.shape[0], block):
            blk = cap[lo:lo + block]
            a = prec.matmul(im.reshape(-1, d), blk.reshape(-1, d).t())
            out.append(a.reshape(n_im, r, blk.shape[0], -1).amax(dim=1).sum(dim=-1))
    return torch.cat(out, dim=1)


@torch.no_grad()
def recall(scores: torch.Tensor, per_image: int) -> Dict[str, float]:
    """R@1/5/10 and medr both ways of a (N, per_image * N) matrix whose
    columns come in groups of ``per_image`` an image."""
    n = scores.shape[0]
    gt = torch.arange(n, device=scores.device)
    i2t = []
    for j in range(per_image):
        own = scores[gt, gt * per_image + j]
        i2t.append((scores > own[:, None]).sum(dim=1))
    i2t = torch.stack(i2t, dim=1).amin(dim=1)
    t2i = []
    for lo in range(0, scores.shape[1], 4096):
        cols = scores[:, lo:lo + 4096]
        own = cols[torch.arange(lo, lo + cols.shape[1], device=cols.device) // per_image,
                   torch.arange(cols.shape[1], device=cols.device)]
        t2i.append((cols > own[None, :]).sum(dim=0))
    t2i = torch.cat(t2i)
    out = {}
    for name, ranks in (("i2t", i2t), ("t2i", t2i)):
        r = ranks.cpu().numpy()
        for k in (1, 5, 10):
            out[f"{name}_r{k}"] = 100.0 * float((r < k).sum()) / len(r)
        out[f"{name}_medr"] = float(np.floor(np.median(r)) + 1)
    return out
