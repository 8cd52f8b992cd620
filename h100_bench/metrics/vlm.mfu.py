"""The re-captioner's model FLOPs (``lib/vlm_bounds.py::sequence_flops``:
each image's prompt and its 128 tokens over the active parameters, and
the plain attention over the valid keys) over the traced window at the
bf16 peak (989 TFLOP/s), in %."""

from h100_bench.lib.bounds import PEAK_OPS_PER_S


def read(r):
    c = r.counters
    if r.view is None or not c.get("model_flops"):
        return None
    return 100.0 * c["model_flops"] / (r.view.window_s * PEAK_OPS_PER_S["bf16"])
