"""Logging, meters, and TensorBoard observability.

Reference contract (SURVEY.md S5.5): console logger "vlpretrain"
(ref:oscar/utils/logger.py:83-101 + ref:alad/train.py:187-189), windowless
running meters (ref:alad/evaluation.py:22-77 AverageMeter/LogCollector),
per-step tensorboard scalars {epoch, step, batch_time, data_time, lr, every
loss meter} and validation scalars {matching/r*, alignment/r*, rsum}
(ref:alad/train.py:441-446,483-528). Scalar names are kept identical so
dashboards transfer.

A copy of aladin_tpu/utils/logging.py. ``make_tb_writer`` imports
TensorBoard's writer lazily and is a no-op without it; the OSCAR task
drivers use it (utils/metric_logger.py), while the port's Trainer writes its
meters and validation recalls to the log only.
"""

from __future__ import annotations

import logging
import os
import sys
from collections import OrderedDict
from typing import Optional


def setup_logger(name: str = "vlpretrain", save_dir: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler) for h in logger.handlers):
        h = logging.StreamHandler(stream=sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if save_dir:
        # one file handler per run directory (several CLIs may share the
        # process, e.g. under pytest - each still gets its own log.txt)
        path = os.path.abspath(os.path.join(save_dir, "log.txt"))
        if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
            os.makedirs(save_dir, exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class AverageMeter:
    """Running value/average (ref:alad/evaluation.py:22-47)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 0):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / (0.0001 + self.count)

    def __str__(self):
        if self.count == 0:
            return str(self.val)
        return f"{self.val:.4f} ({self.avg:.4f})"


class LogCollector:
    """Ordered dict of meters + tensorboard dump (ref:alad/evaluation.py:50-77)."""

    def __init__(self):
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()

    def update(self, k: str, v, n: int = 0):
        self.meters.setdefault(k, AverageMeter()).update(v, n)

    def __str__(self):
        return "  ".join(f"{k} {v}" for k, v in self.meters.items())


class NoOpWriter:
    def add_scalar(self, *a, **kw):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def make_tb_writer(log_dir: str):
    """TensorBoard writer, no-op if torch's tensorboard is unavailable."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except ImportError:
        return NoOpWriter()
