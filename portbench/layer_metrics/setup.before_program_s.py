"""Seconds of set-up before the program's first span: from the process's
start (``/proc``) to the first interval of the program's timeline, so the
interpreter, ``import torch`` and the port's modules, and the harness's front
(its modules, CUDA's initialisation); None where the program keeps no
timeline."""

from portbench.layer_metrics import _setup_split


def read(rec):
    parts = _setup_split.split(rec)
    return None if parts is None else parts["before_program"]
