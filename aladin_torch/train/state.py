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

On the card the optimizer is ``Adam(capturable=True)`` with its learning
rate in a one-element device tensor, so that a CUDA graph can capture the
step (``train/step.py::make_multi_train_step``): the eager step writes the
schedule's value into that tensor, a graph copies it from the window's lr
vector. ``optimizer_state_dict`` / ``load_optimizer_state_dict`` give and
take the eager form (a float lr, ``capturable`` False, CPU step counts)
whatever the mode, so checkpoints keep one format and load either way.

Under tensor parallelism (``mesh``, set with the model's sharding) the
parameters, their gradients and Adam's moments are this rank's slices;
``grad_norm`` and the clip take the unsharded model's norm
(``parallel/sharding.py::global_norm_tp``).

Auxiliary learnables owned here:
  * the 'auto' loss weights s_k, initialised to -2.3 (learnable, unlike the
    reference's, which never reach its optimizer);
  * the mse-distillation affine wb = [0.5, 0.5].
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
from torch import nn

from aladin_torch.config import ExperimentConfig
from aladin_torch.parallel.sharding import global_norm_tp
from aladin_torch.train.schedule import clip_by_global_norm_, global_norm, make_lr_schedule

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
        self.mesh = None  # a mesh with a tp axis once the model is sharded over it
        self.schedule = make_lr_schedule(cfg.training, steps_per_epoch)
        frozen = FROZEN_WITH_TERAN if cfg.model.freeze_teran else ()
        self.trainable: List[nn.Parameter] = []
        self.frozen: List[nn.Parameter] = []
        for name, p in model.named_parameters():
            (self.frozen if name.split(".")[0] in frozen else self.trainable).append(p)
        self.trainable += list(self.aux.values())
        self.capturable = device.type == "cuda"
        lr = self.schedule(0)
        if self.capturable:
            lr = torch.tensor(lr, dtype=torch.float32, device=device)
        self.optimizer = torch.optim.Adam(self.trainable, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                          capturable=self.capturable)

    def parameters(self) -> Iterable[nn.Parameter]:
        """Every parameter that takes a gradient (frozen ones included)."""
        return self.trainable + self.frozen

    def named_params(self) -> Dict[str, torch.Tensor]:
        """Model state names plus ``aux.<name>`` for the aux learnables."""
        out = dict(self.model.named_parameters())
        out.update({f"aux.{k}": v for k, v in self.aux.items()})
        return out

    def grad_norm(self, params: Iterable[nn.Parameter]) -> torch.Tensor:
        """The global norm of the gradients of ``params`` (those that have
        one), an f32 device scalar; under tp the unsharded model's."""
        if self.mesh is not None and self.mesh.tp > 1:
            return global_norm_tp(params, self.mesh)
        return global_norm([p.grad for p in params if p.grad is not None])

    @property
    def schedule_step(self) -> int:
        """The schedule's count: updates since the optimizer started fresh."""
        return self.step - self.schedule_offset

    def apply_gradients(self, lr: Optional[torch.Tensor] = None) -> None:
        """Clip the trainable gradients to ``grad-clip`` by their global
        norm, take one Adam step at this step's learning rate, count it.
        ``lr``: a one-element device tensor holding the rate (a CUDA graph's
        slot, written before each replay) instead of the schedule's value."""
        grads = [p.grad for p in self.trainable if p.grad is not None]
        clip = self.cfg.training.grad_clip
        if clip > 0 and grads:
            clip_by_global_norm_(grads, clip, self.grad_norm(self.trainable))
        for group in self.optimizer.param_groups:
            if lr is not None:
                group["lr"].copy_(lr)
            elif self.capturable:
                group["lr"].fill_(self.schedule(self.schedule_step))
            else:
                group["lr"] = self.schedule(self.schedule_step)
        self.optimizer.step()
        self.step += 1

    def optimizer_state_dict(self) -> Dict[str, Any]:
        """The optimizer's state dict in the eager form (float lr,
        ``capturable`` False, step counts on the CPU): one checkpoint format
        for both modes. The moment tensors are the live ones, not copies."""
        sd = self.optimizer.state_dict()
        groups = [{**g, "lr": float(g["lr"]), "capturable": False} for g in sd["param_groups"]]
        state = {i: {k: (v.detach().cpu() if k == "step" else v) for k, v in st.items()}
                 for i, st in sd["state"].items()}
        return {"state": state, "param_groups": groups}

    def load_optimizer_state_dict(self, sd: Dict[str, Any]) -> None:
        """Load a state dict of either form into this optimizer, keeping its
        own mode: ``capturable``, the lr tensor and where the step counts
        live (the card for a capturable optimizer, the CPU otherwise)."""
        group = self.optimizer.param_groups[0]
        lr = group["lr"]
        self.optimizer.load_state_dict(sd)
        for g in self.optimizer.param_groups:
            g["capturable"] = self.capturable
            if self.capturable:
                lr.fill_(float(g["lr"]))
                g["lr"] = lr
            else:
                g["lr"] = float(g["lr"])
        for p, st in self.optimizer.state.items():
            if "step" in st:
                dev = p.device if self.capturable else "cpu"
                st["step"] = st["step"].detach().to(device=dev, dtype=torch.float32)
