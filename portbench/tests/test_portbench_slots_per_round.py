"""The reader of ``kernel.qam_eq.slots_per_round``: the program's counters
``qam_eq_scan.slots`` over ``qam_eq_scan.rounds`` where it keeps both, nothing
where it has no such counters (a program before them), ran no round, or
keeps no totals at all."""

import sys

from portbench.core import registry, runner, window

NAME = "kernel.qam_eq.slots_per_round"


def _read(rec):
    return registry.module("layer_metrics", NAME).read(rec)


def _record():
    return runner.Record(config={}, workload={"warmup_blocks": 4}, samples_per_block=1,
                         setup_s=1.0, window=window.Window(first=4, blocks=26), peaks=None)


def _totals(counters):
    return {"spans": {}, "counters": counters, "launches": {}}


def test_slots_over_rounds_where_the_program_counts_both(monkeypatch):
    from yagi_tpu_torch import trace

    counts = {"qam_eq_scan.slots": 2048 * 8192 * 30, "qam_eq_scan.rounds": 2048 * 1950 * 30,
              "library.builds": 0}
    monkeypatch.setattr(trace, "snapshot", lambda: _totals(counts))
    assert _read(_record()) == 8192 / 1950


def test_nothing_without_the_counters_or_a_round(monkeypatch):
    from yagi_tpu_torch import trace

    for counts in ({"library.builds": 0}, {"qam_eq_scan.slots": 0, "qam_eq_scan.rounds": 0}):
        monkeypatch.setattr(trace, "snapshot", lambda c=counts: _totals(c))
        assert _read(_record()) is None
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # import raises
    assert _read(_record()) is None
