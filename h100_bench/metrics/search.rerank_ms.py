"""The median host time of a query's rerank, the program's span
``search.rerank`` (``eval/search.py``: the normalisation, the vmapped MrSw
blocks over the shortlist, the top-k and the gather), in ms."""

from h100_bench.lib import spans


def read(r):
    if r.view is None:
        return None
    return spans.median_ms(r.view.span_durations("search.rerank"))
