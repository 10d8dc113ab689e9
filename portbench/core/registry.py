"""Files of the benchmark found by name: ``<kind>/<name>.json`` for data,
``<kind>/<name>.py`` for code. A new cell, configuration, signal, reference,
work count or metric is a new file; nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not _NAME.fullmatch(name):
        raise ValueError(f"{kind}: {name!r} is not a valid name")
    path = PKG / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{kind}: no file {path.relative_to(ROOT)} for {name!r}")
    return path


def data(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    return json.loads(_path(kind, name, ".json").read_text())


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded once (a name may hold dots, so
    it is loaded by path)."""
    key = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, _path(kind, name, ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    """The workload entry of ``bench`` named ``name``."""
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with ``trace`` on; an entry
    with a ``workloads`` key counts only for the cells it lists."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell_name in m["workloads"]]
