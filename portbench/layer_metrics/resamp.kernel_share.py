"""Share of the arbitrary resampler's u32 PFB calls that ran its kernel
(``csrc/resamp.cu``): the launches of ``resamp_u32_apply`` over the program's
counter ``resamp.calls`` (the wrapper's calls on either route), both counted
whether tracing is on or off, over every call of the process; None where the
program keeps no such launch count or counter (a program before the kernel),
or made no such call."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    if program is None:
        return None
    launches = program["launches"].get("resamp_u32_apply")
    calls = program["counters"].get("resamp.calls", 0)
    return launches / calls if calls and launches is not None else None
