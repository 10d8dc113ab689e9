"""The program's set-up on the clock ``setup_s`` is read on: the set-up
intervals of ``yagi_tpu_torch.trace``'s timeline (``snapshot()["timeline"]``:
``yagi.device``, ``yagi.library``, each ``create``, each entry's first step),
put on the wall clock by the timeline's anchor, beside the process's start
as ``portbench/core/runner.py::process_start`` reads it from ``/proc`` (10-ms
ticks). None where the program keeps no timeline."""

from __future__ import annotations

import functools

from portbench.core import runner, stats
from portbench.layer_metrics import _program


@functools.cache
def _start() -> float:
    """The process's start on the wall clock, read once so that every reader
    of a run splits the same set-up."""
    return runner.process_start()


def timed(program: dict | None) -> bool:
    """Whether the program keeps a timeline (and so its set-up spans)."""
    return program is not None and "timeline" in program


def split(rec) -> dict | None:
    """Seconds of ``setup_s``: ``before_program`` from the process's start to
    the first interval of the timeline (the interpreter, ``import torch``, the
    port's modules, the harness's front); ``spanned`` the union of the set-up
    intervals inside the set-up; ``unspanned`` the rest, the harness's work
    between the program's spans (the inputs, the later warm-up blocks)."""
    program = _program.totals()
    if not timed(program):
        return None
    tl = program["timeline"]
    offset = tl["anchor"]["wall_ns"] - tl["anchor"]["clock_ns"]
    start = _start()
    end = start + rec.setup_s

    def wall(ns: int) -> float:
        return (ns + offset) / 1e9

    first = min([wall(a) for _, a, _ in tl["setup"] + tl["steps"]], default=end)
    before = min(max(first, start), end) - start
    spanned = stats.covered([(wall(a), wall(b)) for _, a, b in tl["setup"]], start, end)
    return {"before_program": before, "spanned": spanned,
            "unspanned": rec.setup_s - before - spanned}
