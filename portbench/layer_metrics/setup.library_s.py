"""Seconds of set-up in the kernels' library: the program's span
``yagi.library`` (its sources hashed, the library built or found, loaded and
bound), timed on the library's first use whether tracing is on or off; 0
where no kernel ran."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    return None if program is None else program["spans"].get("yagi.library", {"ns": 0})["ns"] / 1e9
