"""``BENCHMARK.json`` against the contract's shapes: names, units and lines
in their characters, every entry's files present, every metric's reader."""

import json
import re

import pytest

from portbench.core import registry

BENCH = registry.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\n\t]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/") and len(BENCH["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((registry.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        names.append(w["name"])
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert LINE.fullmatch(w["why"]) and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.fullmatch(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(NAME.fullmatch(n) for n in names)
    assert len(set(n for n in names)) == len(names)


def test_every_entry_has_its_files():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((registry.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
        registry.module("drivers", data["driver"])
        registry.module("reference", data["driver"])
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        wl = registry.data("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        registry.module("signals", wl["signal"])
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for m in BENCH["end_to_end"]:
        assert callable(registry.module("end_to_end", m["name"]).read)
    for m in BENCH["per_layer"]:
        assert callable(registry.module("layer_metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in registry.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_of(BENCH, cell, True)


def test_the_check_fits_the_budget_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
