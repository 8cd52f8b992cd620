"""VQA / GQA / NLVR2 classification over the cross-modal backbone (mirrors
aladin_tpu/tasks/classification.py).

Equivalent capability to ref:oscar/run_vqa.py / run_gqa.py / run_nlvr.py:

  * VQA: 3129-way answer classification over the joint (question, regions)
    stream; losses bce (instance BCE x n_labels, ref:modeling_bert.py:282-287
    + :348-349), kl (soft answer scores, :341-347) or ce;
  * GQA: single-answer CE over the same encoder;
  * NLVR2: two images per example - pair-choice over concatenated pooled
    outputs (ImageBertForMultipleChoice semantics,
    ref:modeling_bert.py:357-467 capability).

The multiple-choice heads keep aladin_tpu's module names (``cls``,
``cls_fc1``, ``cls_fc2``): its converter maps no reference name for them.

Data parallelism (``mesh=``): each rank holds B / dp rows; the loss is the
global batch's (for every loss type its sum over every rank's rows divided
by the global B), and one all-reduce of the flat gradients gives its
gradient on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aladin_torch.models.bert_img import BertImgConfig, BertImgModel
from aladin_torch.parallel.mesh import Mesh, all_reduce_sum_
from aladin_torch.train.schedule import AdamW
from aladin_torch.train.step import average_gradients, compute_autocast


def classification_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                            loss_type: str = "ce") -> torch.Tensor:
    """The loss summed over the batch rows: ``classification_loss`` times B."""
    logits = logits.float()
    if loss_type == "ce":
        return F.cross_entropy(logits, labels.long(), reduction="sum")
    if loss_type == "bce":
        return F.binary_cross_entropy_with_logits(logits, labels.float(), reduction="sum")
    if loss_type == "kl":
        logp = F.log_softmax(logits, dim=-1)
        q = labels.float()
        q_logq = torch.where(q > 0, q * torch.log(q.clamp(min=1e-38)), torch.zeros_like(q))
        return torch.sum(q_logq - q * logp)
    raise ValueError(loss_type)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        loss_type: str = "ce") -> torch.Tensor:
    """ce: integer labels; bce: multi-hot soft targets scaled by n_labels
    (instance_bce_with_logits, ref:modeling_bert.py:282-287); kl: soft
    scores vs log-softmax, summed over the batch and divided by B (q log q
    taken as 0 where q is 0, as torch's kl_div; ref:modeling_bert.py:341-347)."""
    return classification_loss_sum(logits, labels, loss_type) / logits.shape[0]


def classifier_logits(model: nn.Module, ids, mask, seg, feats) -> torch.Tensor:
    """The logits of an ImageBertClassifier (its first output) or of a
    multiple-choice head."""
    out = model(ids, mask, seg, feats)
    return out[0] if isinstance(out, tuple) else out


def make_classifier_train_step(model: nn.Module, optimizer: AdamW, loss_type: str = "bce",
                               compute_dtype: Optional[torch.dtype] = None,
                               mesh: Optional[Mesh] = None):
    """step(ids, mask, seg, feats, labels) -> {"loss", "logits"} after one
    AdamW update of a classifier or multiple-choice head; the loss is the
    global batch's with ``mesh`` (logits: this rank's rows)."""
    dp = mesh.size if mesh is not None else 1

    def step(ids, mask, seg, feats, labels) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        with compute_autocast(ids.device, compute_dtype):
            logits = classifier_logits(model, ids, mask, seg, feats)
        total = classification_loss_sum(logits, labels, loss_type)
        rows = torch.stack([total.detach(), torch.ones_like(total) * logits.shape[0]])
        if mesh is not None:
            rows = all_reduce_sum_(mesh, rows)
        # dp times this rank's share: the gradient average below divides by dp
        (dp * total / rows[1]).backward()
        if mesh is not None:
            average_gradients(mesh, [p.grad for p in optimizer.params if p.grad is not None])
        optimizer.step()
        return {"loss": rows[0] / rows[1], "logits": logits.detach()}

    return step


def make_predict_step(model: nn.Module, compute_dtype: Optional[torch.dtype] = None):
    """predict(ids, mask, seg, feats) -> (argmax, softmax) of the model's
    ``classifier_logits``, in eval mode."""

    @torch.inference_mode()
    def predict(ids, mask, seg, feats):
        model.eval()
        with compute_autocast(ids.device, compute_dtype):
            logits = classifier_logits(model, ids, mask, seg, feats).float()
        return logits.argmax(-1), torch.softmax(logits, dim=-1)

    return predict


def vqa_score(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    """The VQA accuracy surrogate: score of the argmax answer under the
    soft target distribution (ref:run_vqa.py compute_score_with_logits
    capability)."""
    pred = logits.argmax(-1)
    return torch.take_along_dim(soft_targets, pred[:, None], dim=1).mean()


def _mlp_or_linear(cfg: BertImgConfig, module: nn.Module, classifier: str, in_dim: int,
                   num_labels: int, cls_hidden_scale: int) -> None:
    if classifier == "linear":
        module.cls = nn.Linear(in_dim, num_labels)
    else:
        module.cls_fc1 = nn.Linear(in_dim, cfg.hidden_size * cls_hidden_scale)
        module.cls_fc2 = nn.Linear(cfg.hidden_size * cls_hidden_scale, num_labels)


def _head(module: nn.Module, classifier: str, x: torch.Tensor) -> torch.Tensor:
    if classifier == "linear":
        return module.cls(x)
    return module.cls_fc2(torch.relu(module.cls_fc1(x)))


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


class ImageBertForMultipleChoice(nn.Module):
    """NLVR2 pair-choice head (ref:modeling_bert.py:357-467): each choice's
    (statement, image) stream encodes independently; pooled outputs
    CONCATENATE across choices -> one classifier over num_choices*hidden
    ('linear' or 'mlp' head, ref:modeling_bert.py:375-394)."""

    def __init__(self, cfg: BertImgConfig, num_choices: int = 2, num_labels: int = 2,
                 classifier: str = "mlp", cls_hidden_scale: int = 2):
        super().__init__()
        self.classifier = classifier
        self.bert = BertImgModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        _mlp_or_linear(cfg, self, classifier, num_choices * cfg.hidden_size, num_labels,
                       cls_hidden_scale)

    def forward(self, ids, mask, seg, feats) -> torch.Tensor:
        """ids/mask/seg/feats: (B, num_choices, ...) stacked choice streams
        -> (B, num_labels) logits."""
        _, pooled, _, _ = self.bert(_flat(ids), _flat(mask), _flat(seg), _flat(feats))
        return _head(self, self.classifier, self.dropout(pooled).reshape(ids.shape[0], -1))


class OscarForMultipleChoice(nn.Module):
    """Per-choice scorer (ref:modeling_bert.py:470-572): each choice stream
    encodes AND classifies independently -> (B, num_choices, num_labels)
    logits. 'linear' head = Linear(hidden, num_labels); 'mlp' adds the
    cls_hidden_scale bottleneck."""

    def __init__(self, cfg: BertImgConfig, num_labels: int = 2, classifier: str = "linear",
                 cls_hidden_scale: int = 2):
        super().__init__()
        self.num_labels, self.classifier = num_labels, classifier
        self.bert = BertImgModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        _mlp_or_linear(cfg, self, classifier, cfg.hidden_size, num_labels, cls_hidden_scale)

    def forward(self, ids, mask, seg, feats) -> torch.Tensor:
        b, c = ids.shape[:2]
        _, pooled, _, _ = self.bert(_flat(ids), _flat(mask), _flat(seg), _flat(feats))
        return _head(self, self.classifier, self.dropout(pooled)).reshape(b, c, self.num_labels)
