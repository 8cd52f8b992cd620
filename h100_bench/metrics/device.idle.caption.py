"""The device's idle share of the traced window: 1 - (union of the device
operations' intervals) / the window, in %."""


def read(r):
    if r.view is None or r.view.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.view.busy_s / r.view.window_s)
