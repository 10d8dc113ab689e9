"""The readers of the program's own spans and counters
(``yagi_tpu_torch.trace``): the numbers they give from set totals, nothing
where the program keeps no totals (a port without the tracing module), and
each of them in a traced run on the CPU."""

import sys

import pytest

from portbench.core import registry, runner, window
from portbench.tests.helpers import TINY, tiny_run

NEW = ("dispatch.launches_per_step", "setup.library_s", "setup.create_s",
       "setup.library_builds")


def _read(name, rec):
    return registry.module("layer_metrics", name).read(rec)


def _record(warmup=4, blocks=26):
    return runner.Record(config={}, workload={"warmup_blocks": warmup}, samples_per_block=1,
                         setup_s=1.0, window=window.Window(first=warmup, blocks=blocks),
                         peaks=None)


def _totals(spans, counters, launches):
    return {"spans": {n: {"count": 1, "ns": ns, "self_ns": ns} for n, ns in spans.items()},
            "counters": counters, "launches": launches}


def test_readers_of_set_totals(monkeypatch):
    from yagi_tpu_torch import trace

    totals = _totals({"yagi.library": 250_000_000, "yagi.rxchain.create": 100_000_000,
                      "yagi.rxchain.taps": 50_000_000, "yagi.qamrx.create": 300_000_000,
                      "yagi.rxchain.step": 7_000_000},
                     {"library.builds": 1}, {"agc_scan_apply": 60, "qam_eq_scan_apply": 30})
    monkeypatch.setattr(trace, "snapshot", lambda: totals)
    rec = _record()
    assert _read("dispatch.launches_per_step", rec) == 90 / 30
    assert _read("setup.library_s", rec) == 0.25
    assert _read("setup.create_s", rec) == pytest.approx(0.4)  # the taps lie inside create
    assert _read("setup.library_builds", rec) == 1


def test_a_warm_run_reads_no_build_and_a_cpu_run_no_library(monkeypatch):
    from yagi_tpu_torch import trace

    monkeypatch.setattr(trace, "snapshot", lambda: _totals({}, {}, {"mix_down_apply": 0}))
    rec = _record()
    assert _read("setup.library_builds", rec) == 0
    assert _read("setup.library_s", rec) == 0.0
    assert _read("setup.create_s", rec) == 0.0
    assert _read("dispatch.launches_per_step", rec) == 0.0


def test_a_program_without_the_tracing_module_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # import raises
    for name in NEW:
        assert _read(name, _record()) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_traced_run_reports_them(cell):
    line = tiny_run(cell, trace=True).line
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(metrics)
    assert metrics["dispatch.launches_per_step"] == 0.0  # the CPU route launches nothing
    assert metrics["setup.library_builds"] == 0 and metrics["setup.library_s"] == 0.0
    assert metrics["setup.create_s"] > 0
