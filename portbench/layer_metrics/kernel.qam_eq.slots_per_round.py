"""Slots a round of ``qam_eq_scan``'s register instance (``csrc/qam.cu``): the
program's counters ``qam_eq_scan.slots`` (the slots the wrapper handed over,
a host count) over ``qam_eq_scan.rounds`` (the rounds the kernel ran, summed
over channels, on the device), over every call of the process; None where the
program keeps no such counters, or ran no round."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    if program is None:
        return None
    counters = program["counters"]
    rounds = counters.get("qam_eq_scan.rounds", 0)
    return counters.get("qam_eq_scan.slots", 0) / rounds if rounds else None
