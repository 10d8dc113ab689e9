"""The program's own totals for the readers of its spans and counters:
``yagi_tpu_torch.trace.snapshot()``, the process's spans, counters and kernel
launches as plain numbers, or None where the program keeps no such totals."""

from __future__ import annotations

import importlib


def totals() -> dict | None:
    try:
        trace = importlib.import_module("yagi_tpu_torch.trace")
    except ModuleNotFoundError:
        return None
    return trace.snapshot()
