"""Seconds of set-up making the card's context: the program's span
``yagi.device`` (``_src/device.py::resolve_device``, the first resolve of a
CUDA device in the process, before the entry's ``create`` opens), timed
whether tracing is on or off; 0 on the CPU; None where the program keeps no
timeline (and so no such span)."""

from portbench.layer_metrics import _program, _setup_split


def read(rec):
    program = _program.totals()
    if not _setup_split.timed(program):
        return None
    return program["spans"].get("yagi.device", {"ns": 0})["ns"] / 1e9
