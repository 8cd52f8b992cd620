"""The device's idle time a train window inside the program's ``step.*``
spans (``train/step.py``: the fill, the replay's launch, the metrics'
copy): idle seconds inside them over the windows replayed (``step.replay``
spans), in ms."""

from h100_bench.lib import spans


def read(r):
    if r.view is None:
        return None
    windows = len(r.view.span_durations("step.replay"))
    if not windows:
        return None
    return 1e3 * spans.idle_seconds(r.view, "step.") / windows
