"""Seconds of set-up in the entry object's ``create``: the program's spans
``yagi.<object>.create`` (the filter designs, the state made on the device,
the chain's compact taps), timed whether tracing is on or off; a run
creates one entry object a process."""

import re

from portbench.layer_metrics import _program

_CREATE = re.compile(r"yagi\.\w+\.create")


def read(rec):
    program = _program.totals()
    if program is None:
        return None
    return sum(t["ns"] for name, t in program["spans"].items() if _CREATE.fullmatch(name)) / 1e9
