"""Host ms a step inside the entry call (the port's Python, the kernel
wrappers' checks, the ctypes launches, torch's dispatch), by the host clock
over the window's steps outside the profiled slice."""


def read(rec):
    w = rec.window
    return 1e3 * w.host_entry / w.host_steps if w.host_steps else None
