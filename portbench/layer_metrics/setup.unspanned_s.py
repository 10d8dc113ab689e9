"""Seconds of set-up outside every program span: ``setup_s`` less
``setup.before_program_s`` less the union of the program's set-up intervals
(``yagi.device``, ``yagi.library``, the entry's ``create``, its first step).
That is the harness's work between the program's spans: the inputs made on
the card, the later warm-up blocks and their synchronize, a cell's CUDA-graph
capture. None where the program keeps no timeline."""

from portbench.layer_metrics import _setup_split


def read(rec):
    parts = _setup_split.split(rec)
    return None if parts is None else parts["unspanned"]
