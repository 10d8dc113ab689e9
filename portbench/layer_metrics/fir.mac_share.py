"""Share of the banded-matmul FIRs' multiply-adds that their taps need: the
program's counters ``conv.tap_macs`` (B·n_out·L a filter) over ``conv.macs``
(B·nb·128·K, what the matmul runs, the band's zeros with it), both host
counts over every call of the process; None where the program keeps no such
counters (a program before them), or ran no such matmul."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    if program is None:
        return None
    macs = program["counters"].get("conv.macs", 0)
    return program["counters"].get("conv.tap_macs", 0) / macs if macs else None
