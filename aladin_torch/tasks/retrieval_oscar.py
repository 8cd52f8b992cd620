"""Legacy OSCAR cross-modal retrieval task, the entangled baseline (mirrors
aladin_tpu/tasks/retrieval_oscar.py).

Equivalent capability to ref:oscar/run_retrieval.py: joint (caption, image)
pair CLASSIFICATION - training samples a random in-dataset negative per
positive (:210-225), evaluation scores N x N pairs through the joint encoder
(cross_image_eval :107-112,246-248) and computes ranks from the pair
probabilities (:264-293). This is the pipeline that produced the OSCAR/VinVL
baseline numbers ALADIN distills from; it is quadratic at retrieval time -
the motivation for ALADIN's disentangled design.

The pair step runs forward, loss, backward and AdamW eagerly; evaluation
reuses tasks/oscar_teacher.py's streamed pair scorer. Data parallelism
(``mesh=``): each rank holds its rows of the global pair batch, and the loss
and accuracy are the global batch's (sums over every rank's rows over the
global row count), as aladin_tpu's SPMD step computes them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aladin_torch.models.bert_img import ImageBertClassifier
from aladin_torch.parallel.mesh import Mesh, all_reduce_sum_
from aladin_torch.train.schedule import AdamW
from aladin_torch.train.step import average_gradients, compute_autocast


def pair_loss_sum(logits: torch.Tensor, labels: torch.Tensor, loss_type: str = "ce"
                  ) -> torch.Tensor:
    """The pair loss summed over the rows: 'ce' (softmax CE over {mismatched,
    matched}, the retrieval default) or 'bce' (sigmoid BCE against the
    one-hot labels summed over the classes, optax's mean times n_labels)."""
    logits = logits.float()
    if loss_type == "ce":
        return F.cross_entropy(logits, labels.long(), reduction="sum")
    if loss_type == "bce":
        onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
        return F.binary_cross_entropy_with_logits(logits, onehot, reduction="sum")
    raise ValueError(loss_type)


def make_pair_train_step(model: ImageBertClassifier, optimizer: AdamW, loss_type: str = "ce",
                         compute_dtype: Optional[torch.dtype] = None,
                         mesh: Optional[Mesh] = None):
    """step(ids, mask, seg, feats, labels) -> {"loss", "acc"} (the global
    batch's with ``mesh``) after one AdamW update (ref:run_retrieval.py:
    316-417 semantics)."""
    if loss_type not in ("ce", "bce"):
        raise ValueError(loss_type)
    dp = mesh.size if mesh is not None else 1

    def step(ids, mask, seg, feats, labels) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        with compute_autocast(ids.device, compute_dtype):
            logits = model(ids, mask, seg, feats)[0]
        total = pair_loss_sum(logits, labels, loss_type)
        correct = (logits.argmax(-1) == labels).sum().float()
        rows = torch.stack([total.detach(), correct, torch.ones_like(correct) * logits.shape[0]])
        if mesh is not None:
            rows = all_reduce_sum_(mesh, rows)
        # dp times this rank's share: the gradient average below divides by dp
        (dp * total / rows[2]).backward()
        if mesh is not None:
            average_gradients(mesh, [p.grad for p in optimizer.params if p.grad is not None])
        optimizer.step()
        return {"loss": rows[0] / rows[2], "acc": rows[1] / rows[2]}

    return step


def sample_pairs(dataset, indices, rng: np.random.RandomState):
    """Positive + random negative per index (ref:run_retrieval.py:210-225):
    with p=0.5 a random caption from another image, else a random other
    image with the anchor caption. Returns stacked joint streams + labels."""
    ids_l, mask_l, seg_l, feats_l, labels = [], [], [], [], []
    n_img = len(dataset.img_keys)
    ncpi = dataset.num_captions_per_img
    for index in indices:
        img_idx = index // ncpi
        cap_idx = index % ncpi
        key = dataset.img_keys[img_idx]
        feats = dataset.get_image(key)
        caption = dataset.captions[key][cap_idx]
        od = dataset.get_od_labels(key)
        pos = dataset.tensorizer.tensorize_joint(caption, od, feats)

        neg_img_idx = rng.randint(n_img - 1)
        if neg_img_idx >= img_idx:
            neg_img_idx += 1
        if rng.rand() <= 0.5:
            neg_cap = dataset.captions[dataset.img_keys[neg_img_idx]][rng.randint(ncpi)]
            neg = dataset.tensorizer.tensorize_joint(neg_cap, od, feats)
        else:
            neg_key = dataset.img_keys[neg_img_idx]
            neg = dataset.tensorizer.tensorize_joint(
                caption, dataset.get_od_labels(neg_key), dataset.get_image(neg_key))
        for ex, lab in ((pos, 1), (neg, 0)):
            ids_l.append(ex[0])
            mask_l.append(ex[1])
            seg_l.append(ex[2])
            feats_l.append(ex[3])
            labels.append(lab)
    return (np.stack(ids_l), np.stack(mask_l), np.stack(seg_l),
            np.stack(feats_l).astype(np.float32), np.asarray(labels, np.int64))


def ranks_from_pair_probs(probs: np.ndarray, captions_per_image: int = 5):
    """i2t / t2i ranks from the (N_img, N_img * cpi) pair-probability matrix
    (ref:run_retrieval.py:264-293 compute_ranks semantics), through
    eval/recall.py's rank function (count-greater ties, documented
    there)."""
    from aladin_torch.eval.recall import ranks_from_score_matrix

    i2t, t2i = ranks_from_score_matrix(torch.as_tensor(np.asarray(probs)), captions_per_image)
    return i2t.numpy(), t2i.numpy()


def evaluate_cross(model: ImageBertClassifier, dataset, chunk: int = 64) -> Dict[str, float]:
    """cross_image_eval -> R@K both directions (legacy baseline protocol)."""
    from aladin_torch.eval.recall import recall_metrics
    from aladin_torch.tasks.oscar_teacher import cross_scores

    keys = dataset.img_keys
    ncpi = dataset.num_captions_per_img
    feats = {k: dataset.get_image(k) for k in keys}
    ods = {k: dataset.get_od_labels(k) for k in keys}

    def make_pair(i, c):
        key_i = keys[i]
        key_c = keys[c // ncpi]
        caption = dataset.captions[key_c][c % ncpi]
        ex = dataset.tensorizer.tensorize_joint(caption, ods[key_i], feats[key_i])
        return ex[0], ex[1], ex[2], ex[3]

    probs = cross_scores(model, make_pair, len(keys), len(keys) * ncpi, chunk)
    i2t, t2i = ranks_from_pair_probs(probs, ncpi)
    m1, m2 = recall_metrics(i2t), recall_metrics(t2i)
    out = {f"i2t_{k}": v for k, v in m1.items()}
    out.update({f"t2i_{k}": v for k, v in m2.items()})
    out["rsum"] = m1["r1"] + m1["r5"] + m1["r10"] + m2["r1"] + m2["r5"] + m2["r10"]
    return out
