"""Million (image, caption) pairs scored and ranked a second: every
call's pairs over the whole window."""


def read(r):
    return r.items / r.window_s / 1e6 if r.window_s > 0 else None
