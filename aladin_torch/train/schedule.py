"""Learning-rate schedules (mirrors aladin_tpu/train/schedule.py).

  * StepLR over epochs: lr = lr0 * gamma^(epoch // step_size), with
    epoch = step // steps_per_epoch;
  * optional linear warmup: lr *= min(1, (step + 1) / warmup_period).

A schedule is a function of the optimizer's update count taken before the
update (the count starts at 0), as optax evaluates it.
"""

from __future__ import annotations

import math

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


def warmup_linear_schedule(*_args, **_kwargs):
    raise NotImplementedError("the legacy OSCAR tasks' WarmupLinearSchedule is not ported yet "
                              "(ROADMAP.md, queue 1, item 9: OSCAR legacy tasks)")


def make_adamw(*_args, **_kwargs):
    raise NotImplementedError("AdamW (the legacy OSCAR tasks' optimizer) is not ported yet "
                              "(ROADMAP.md, queue 1, item 9: OSCAR legacy tasks)")
