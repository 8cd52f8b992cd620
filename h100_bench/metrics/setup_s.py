"""Seconds from the process's start to the first timed unit: imports,
kernels built or loaded, weights and inputs made, the cell's warm-up."""


def read(r):
    return r.setup_s
