"""Kernel launches a step, all the port's kernel wrappers together: the
program's launch counters, which count whether tracing is on or off, over
every step the process ran (the warm-up blocks and the window's; ``run.py``
runs one cell a process)."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    steps = rec.workload["warmup_blocks"] + rec.window.blocks
    return None if program is None or not steps else sum(program["launches"].values()) / steps
