"""The median host time of a bucketed scoring call outside its scorer
calls: the self time of the program's span ``mrsw.bucketed`` less its
``mrsw.call`` spans (``ops/kernels/alignment_kernel.py``: the bucket split,
the index uploads, the column scatters), in ms."""

from h100_bench.lib import spans


def read(r):
    if r.view is None:
        return None
    return spans.median_ms(spans.self_seconds(r.view, "mrsw.bucketed"))
