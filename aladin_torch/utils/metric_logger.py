"""Windowed metric smoothing (the OSCAR-side logger family; a copy of
aladin_tpu/utils/metric_logger.py).

Equivalent capability to ref:oscar/utils/metric_logger.py:11-185:
SmoothedValue keeps a bounded window for median/avg plus a global average;
MetricLogger aggregates named values; TensorboardLogger mirrors them to TB
(main-process-only, in the reference's DDP world and here).
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        return d[n // 2] if n % 2 else 0.5 * (d[n // 2 - 1] + d[n // 2])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})" for name, m in self.meters.items()
        )


class TensorboardLogger(MetricLogger):
    def __init__(self, log_dir: str, start_iter: int = 0, delimiter: str = "  "):
        super().__init__(delimiter)
        from aladin_torch.utils.logging import make_tb_writer

        self.iteration = start_iter
        self.writer = make_tb_writer(log_dir)

    def update(self, **kwargs):
        super().update(**kwargs)
        for k, v in kwargs.items():
            self.writer.add_scalar(k, float(v), self.iteration)
        self.iteration += 1
