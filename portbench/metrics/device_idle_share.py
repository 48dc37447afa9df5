"""100 x (1 - the device's busy seconds / the host's seconds) over the
window's first clips, profiled with CUDA activities alone between two
host syncs: busy is the union of the device activities' intervals over
every stream, in %."""


def read(rec):
    t = rec.timed
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
