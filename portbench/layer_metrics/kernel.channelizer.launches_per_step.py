"""K2 launches a step: the program's counter ``fused_channelizer_apply``'s
launches, counted whether tracing is on or off, over every step the process
ran (the warm-up blocks and the window's; ``run.py`` runs one cell a
process); None where the program keeps no launch counters."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    steps = rec.workload["warmup_blocks"] + rec.window.blocks
    if program is None or not steps:
        return None
    return program["launches"].get("fused_channelizer_apply", 0) / steps
