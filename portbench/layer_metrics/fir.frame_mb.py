"""MB of frames the banded-matmul FIRs (``filter/_conv.py::_band_frames``)
write to device memory in one step: the program's counter
``conv.frame_bytes`` (B·nb·K·itemsize a matmul, a host count) over its
counter ``fmrx.steps`` (the calls of ``FmStereoRx.step``), in 1e6 bytes.
Both count the calls that ran the step's Python, so a step replayed from a
CUDA graph counts in neither. None where the program keeps no such
counters (a program before them)."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    counters = program["counters"] if program is not None else {}
    steps = counters.get("fmrx.steps", 0)
    if not steps or "conv.frame_bytes" not in counters:
        return None
    return counters["conv.frame_bytes"] / steps / 1e6
