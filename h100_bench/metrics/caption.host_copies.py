"""Device tensors the cached decoder builds from host data a batch: the
program's traced counter ``decode.host_copies`` over its ``decode.cached``
spans (``tasks/decode_cache.py``)."""

from h100_bench.lib import spans


def read(r):
    if r.view is None:
        return None
    batches = len(r.view.span_durations("decode.cached"))
    copies = spans.traced_counter("decode.host_copies")
    if not batches or copies is None:
        return None
    return copies / batches
