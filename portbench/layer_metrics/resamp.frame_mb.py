"""MB of PFB frames that the arbitrary resampler's u32 gather
(``Resamp._gather_dots`` → ``filter/firpfb.py::branch_dots``) writes to device
memory in one call: the program's counters ``resamp.frame_bytes`` (C·cap·L
times the sample's bytes, a host count) over ``resamp.calls``, over every call
of the process, in 1e6 bytes; None where the program keeps no such counters
(a program before them), or made no such call."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    if program is None:
        return None
    counters = program["counters"]
    calls = counters.get("resamp.calls", 0)
    return counters.get("resamp.frame_bytes", 0) / calls / 1e6 if calls else None
