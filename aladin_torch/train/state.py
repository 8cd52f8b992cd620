"""Train state: the model, the auxiliary learnables, Adam, and the step
count (mirrors aladin_tpu/train/state.py).

Optimizer contract: plain Adam (b1 0.9, b2 0.999, eps 1e-8, no weight
decay) over every trainable parameter, after a global-norm gradient clip at
``grad-clip`` taken over those parameters, with the learning rate of
``make_lr_schedule`` at the pre-update schedule count: ``step`` less
``schedule_offset``. The offset is 0 unless the state was resumed from a
weights-only file, where the optimizer restarts and so does its schedule
(optax counts the schedule in the fresh ``opt_state`` in aladin_tpu), while
``step`` keeps the file's Eiters.

freeze-teran: the backbone, the TERAN stacks and the alignment-side depth
aggregation (``FROZEN_WITH_TERAN``) get zero updates, as optax's
multi_transform with ``set_to_zero`` gives them in aladin_tpu: they stay
out of the optimizer and out of the clip norm, but their gradients are
still computed and still count in the ``grad_norm`` metric.

Auxiliary learnables owned here:
  * the 'auto' loss weights s_k, initialised to -2.3 (learnable, unlike the
    reference's, which never reach its optimizer);
  * the mse-distillation affine wb = [0.5, 0.5].
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
from torch import nn

from aladin_torch.config import ExperimentConfig
from aladin_torch.train.schedule import make_lr_schedule

# top-level ALADIN modules (the port's, i.e. the reference torch names)
FROZEN_WITH_TERAN = (
    "oscar_model",
    "transformer_encoder_1",
    "transformer_encoder_2",
    "depth_aggregator_model_alignment",
    "feature_fusion",
)


def make_aux_params(cfg: ExperimentConfig, device=None) -> Dict[str, nn.Parameter]:
    """{"loss_weights.<name>": (1,) parameters, "distill_wb": (2,)}, as the
    recipe needs them."""
    tc = cfg.training
    aux: Dict[str, nn.Parameter] = {}
    if tc.auto_weight:
        for k in tc.loss_types:
            aux[f"loss_weights.{k}"] = nn.Parameter(torch.full((1,), -2.3, device=device))
    if "distillation" in tc.loss_types and tc.distillation_mode == "mse":
        aux["distill_wb"] = nn.Parameter(torch.tensor([0.5, 0.5], device=device))
    return aux


class TrainState:
    """Model + aux parameters, the Adam optimizer over the trainable ones,
    ``step`` (the reference's Eiters) and ``schedule_offset``, the step at
    which the optimizer and its schedule last started fresh."""

    def __init__(self, cfg: ExperimentConfig, model: nn.Module, steps_per_epoch: int = 1000,
                 aux: Dict[str, nn.Parameter] = None):
        self.cfg = cfg
        self.model = model
        device = next(model.parameters()).device
        self.aux = make_aux_params(cfg, device) if aux is None else aux
        self.step = 0
        self.schedule_offset = 0
        self.schedule = make_lr_schedule(cfg.training, steps_per_epoch)
        frozen = FROZEN_WITH_TERAN if cfg.model.freeze_teran else ()
        self.trainable: List[nn.Parameter] = []
        self.frozen: List[nn.Parameter] = []
        for name, p in model.named_parameters():
            (self.frozen if name.split(".")[0] in frozen else self.trainable).append(p)
        self.trainable += list(self.aux.values())
        self.optimizer = torch.optim.Adam(self.trainable, lr=self.schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)

    def parameters(self) -> Iterable[nn.Parameter]:
        """Every parameter that takes a gradient (frozen ones included)."""
        return self.trainable + self.frozen

    def named_params(self) -> Dict[str, torch.Tensor]:
        """Model state names plus ``aux.<name>`` for the aux learnables."""
        out = dict(self.model.named_parameters())
        out.update({f"aux.{k}": v for k, v in self.aux.items()})
        return out

    @property
    def schedule_step(self) -> int:
        """The schedule's count: updates since the optimizer started fresh."""
        return self.step - self.schedule_offset

    def apply_gradients(self) -> None:
        """Clip the trainable gradients to ``grad-clip`` by their global
        norm, take one Adam step at this step's learning rate, count it."""
        grads = [p.grad for p in self.trainable if p.grad is not None]
        clip = self.cfg.training.grad_clip
        if clip > 0 and grads:
            norm = global_norm(grads)
            # optax.clip_by_global_norm: unchanged below the limit, else scaled to it
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.schedule_step)
        self.optimizer.step()
        self.step += 1


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, as an f32 device scalar."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
