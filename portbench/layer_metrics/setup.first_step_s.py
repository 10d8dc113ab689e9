"""Host seconds of the entry's first block: the program's spans
``yagi.<entry>.first_step`` around the first call of the entry's step in the
process (each kernel's first launch, torch's lazy module loads, the caching
allocator's first segments), timed whether tracing is on or off; None where
the program keeps no timeline (and so no such span)."""

import re

from portbench.layer_metrics import _program, _setup_split

_FIRST = re.compile(r"yagi\.\w+\.first_step")


def read(rec):
    program = _program.totals()
    if not _setup_split.timed(program):
        return None
    return sum(t["ns"] for name, t in program["spans"].items() if _FIRST.fullmatch(name)) / 1e9
