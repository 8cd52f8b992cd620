"""Items completed over the whole window: every unit's items over the
window's seconds, queued work waited for."""


def read(r):
    return r.items / r.window_s if r.window_s > 0 else None
