"""Model FLOPs of the window's train steps (``lib/bounds.py::
train_step_model_flops``, no recompute) over the traced window at the
bf16 tensor-core peak, in %."""

from h100_bench.lib.bounds import PEAK_OPS_PER_S


def read(r):
    c = r.counters
    if r.view is None or "model_flops_per_step" not in c:
        return None
    steps = r.units * c["steps_per_unit"]
    return 100.0 * c["model_flops_per_step"] * steps / (r.view.window_s * PEAK_OPS_PER_S["bf16"])
