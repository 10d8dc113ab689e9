"""Builds of the kernels' library in the process: the program's counter
``library.builds``, counted whether tracing is on or off; 1 where a checkout
runs its first time, else 0."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    return None if program is None else program["counters"].get("library.builds", 0)
