"""The share of the region slots K1 multiplies that hold the images' regions:
the program's traced counter ``mrsw.valid_slots`` (N_im x R a launch) over
``mrsw.multiplied_slots``, in %. The second counts the rows of K1's image
operand as the program lays it out (8 x image groups x the slots a group
holds), not passes inside the kernel; the kernel multiplies each such row,
the last two slots of a tail layout in its 16-row tail pass. None where the
program has no such counters."""

from h100_bench.lib import spans


def read(r):
    valid = spans.traced_counter("mrsw.valid_slots")
    multiplied = spans.traced_counter("mrsw.multiplied_slots")
    if not valid or not multiplied:
        return None
    return 100.0 * valid / multiplied
