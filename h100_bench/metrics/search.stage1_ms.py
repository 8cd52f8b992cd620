"""The median host time of a query's stage 1, the program's span
``search.stage1`` (``eval/search.py``: the f32 global product, the
shortlist's top-k), in ms."""

from h100_bench.lib import spans


def read(r):
    if r.view is None:
        return None
    return spans.median_ms(r.view.span_durations("search.stage1"))
