"""The median host time of one cached decode step, the program's span
``decode.step`` (``tasks/decode_cache.py``: the step's launches over every
layer and the MLM head), in ms."""

from h100_bench.lib import spans


def read(r):
    if r.view is None:
        return None
    return spans.median_ms(r.view.span_durations("decode.step"))
