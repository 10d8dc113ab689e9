"""Device operations (kernels, copies, fills) a step in the profiled slice."""


def read(rec):
    s = rec.slice
    return len(s.ops) / s.steps if s is not None and s.steps else None
