"""The decoder's matmul FLOPs (prefill, the cached steps and the MLM head
over the vocabulary, ``lib/bounds.py::caption_decode_flops``) over the
traced window at the f32 peak outside the tensor cores (67 TFLOP/s), in %."""

from h100_bench.lib.bounds import PEAK_OPS_PER_S


def read(r):
    c = r.counters
    if r.view is None or not c.get("decode_flops"):
        return None
    return 100.0 * c["decode_flops"] / (r.view.window_s * PEAK_OPS_PER_S["f32"])
