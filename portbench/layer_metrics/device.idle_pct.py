"""100 × (1 − the union of device-operation intervals over the profiled
slice's wall time)."""


def read(rec):
    s = rec.slice
    if s is None or s.wall_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.wall_s)
