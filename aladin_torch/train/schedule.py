"""Learning-rate schedules and the AdamW of the legacy OSCAR tasks (mirrors
aladin_tpu/train/schedule.py and the optimizer of aladin_tpu/cli/pretrain.py).

  * StepLR over epochs: lr = lr0 * gamma^(epoch // step_size), with
    epoch = step // steps_per_epoch;
  * optional linear warmup: lr *= min(1, (step + 1) / warmup_period);
  * WarmupLinearSchedule (pytorch_transformers'): a linear ramp to lr over
    warmup_steps, then a linear decay to 0 at total_steps.

A schedule is a function of the optimizer's update count taken before the
update (the count starts at 0), as optax evaluates it.

AdamW (``make_adamw``): ``torch.optim.AdamW`` over two parameter groups, the
decayed and the undecayed ones, after an optional global-norm clip. optax
applies ``-lr * (u + wd * p)`` where torch applies ``p * (1 - lr * wd)`` and
then ``-lr * u``: the same sum in another order, so the two agree to f32
rounding, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from aladin_torch.config import TrainingConfig


def make_lr_schedule(tc: TrainingConfig, steps_per_epoch: int):
    """step index -> lr (a Python float)."""
    if tc.scheduler not in ("steplr", None):
        raise ValueError(f"unknown scheduler {tc.scheduler!r}")
    if tc.warmup not in ("linear", None):
        raise ValueError(f"unknown warmup {tc.warmup!r}")

    def schedule(step: int) -> float:
        lr = tc.lr
        if tc.scheduler == "steplr":
            epoch = math.floor(step / steps_per_epoch)
            lr = lr * tc.gamma ** math.floor(epoch / tc.step_size)
        if tc.warmup == "linear":
            lr = lr * min(1.0, (step + 1.0) / tc.warmup_period)
        return lr

    return schedule


def warmup_linear_schedule(lr: float, warmup_steps: int, total_steps: int):
    """The pytorch_transformers WarmupLinearSchedule of the legacy OSCAR tasks
    (ref:oscar/run_retrieval.py:338-346, run_oscarplus_pretrain.py:302-304):
    step -> lr * step / warmup_steps below warmup_steps, then
    lr * max(0, (total_steps - step) / (total_steps - warmup_steps))."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / max(warmup_steps, 1)
        return lr * max(0.0, (total_steps - step) / max(total_steps - warmup_steps, 1))

    return schedule


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, as an f32 device scalar."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: unchanged below ``max_norm``,
    else scaled to it."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def decay_mask(model: nn.Module, exclude_scales: bool = True) -> Dict[str, bool]:
    """{parameter name: whether AdamW decays it}: the decision aladin_tpu's
    mask gives the Flax leaf that the parameter maps to (io/convert.py).

    Undecayed: a leaf named ``bias`` (the biases of torch's own layers:
    Linear, LayerNorm, and MultiheadAttention's ``in_proj_bias``, which
    packs the q/k/v biases), and every parameter of a module whose name
    contains "layernorm" in any case (the BERT LayerNorms). With
    ``exclude_scales`` (train/schedule.py's mask in aladin_tpu, where
    cli/pretrain.py's has no such clause) also every LayerNorm's weight,
    the Flax ``scale``, as in the TE stacks' ``norm1`` / ``norm2``.

    A free parameter of the port's own modules is a Flax ``self.param`` of
    its own name, so a bias there is decayed as in aladin_tpu: the MLM
    head's ``decoder_bias`` (``cls.predictions.bias`` here), which upstream
    leaves undecayed (ROADMAP.md §3)."""
    out: Dict[str, bool] = {}
    for mod_name, mod in model.named_modules():
        builtin = type(mod).__module__.startswith("torch.nn")
        in_ln = "layernorm" in mod_name.lower()
        for p_name, _ in mod.named_parameters(recurse=False):
            bias = builtin and p_name.endswith("bias")
            scale = exclude_scales and isinstance(mod, nn.LayerNorm) and p_name == "weight"
            out[f"{mod_name}.{p_name}" if mod_name else p_name] = not (bias or in_ln or scale)
    return out


class AdamW:
    """``torch.optim.AdamW`` (b1 0.9, b2 0.999) over ``model``'s trainable
    parameters in two groups, weight decay on the ``decay_mask`` ones, after
    a global-norm clip at ``max_grad_norm`` when it is > 0 (optax.chain of
    clip_by_global_norm and adamw); each update takes the schedule's lr at
    the update count before it. ``count``: the updates taken."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float, eps: float = 1e-8, max_grad_norm: float = -1.0,
                 exclude_scales: bool = True):
        mask = decay_mask(model, exclude_scales)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        groups = [{"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
                  {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0}]
        self.optimizer = torch.optim.AdamW(groups, lr=schedule(0), betas=(0.9, 0.999), eps=eps)
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_grad_norm > 0 and grads:
            clip_by_global_norm_(grads, self.max_grad_norm)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


def make_adamw(model: nn.Module, lr_schedule: Callable[[int], float],
               weight_decay: float = 0.05, eps: float = 1e-8,
               max_grad_norm: float = -1.0) -> AdamW:
    """AdamW as the legacy tasks configure it (ref:run_retrieval.py:338-343):
    biases, LayerNorm parameters and LayerNorm scales undecayed."""
    return AdamW(model, lr_schedule, weight_decay, eps, max_grad_norm, exclude_scales=True)
