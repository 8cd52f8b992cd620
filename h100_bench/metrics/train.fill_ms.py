"""The median host time of a train window's fill, the program's span
``step.fill`` (``train/step.py``: the batches copied into the graph's
buffers, the window's learning rates pinned and copied, the gate), in ms."""

from h100_bench.lib import spans


def read(r):
    if r.view is None:
        return None
    return spans.median_ms(r.view.span_durations("step.fill"))
