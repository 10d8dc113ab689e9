"""The split of ``setup_s`` by the program's timeline: the four readers'
arithmetic from a set timeline, nothing where the program keeps no timeline,
and a run of a resized cell whose parts are each at least 0 and add up to
its ``setup_s``; on the card, the context's seconds in ``setup.device_s``."""

import sys

import pytest

from portbench.core import registry, runner, stats, window
from portbench.layer_metrics import _setup_split
from portbench.tests.helpers import SEED, TINY

SPLIT = ("setup.before_program_s", "setup.device_s", "setup.first_step_s", "setup.unspanned_s")
S = 10**9


def _read(name, rec):
    return registry.module("layer_metrics", name).read(rec)


def _record(setup_s):
    return runner.Record(config={}, workload={}, samples_per_block=1, setup_s=setup_s,
                         window=window.Window(first=0), peaks=None)


def test_readers_of_a_set_timeline(monkeypatch):
    """The process started at wall 100 s; the timeline's clock reads 0 at
    wall 90 s; set-up ran to wall 110 s. The spans: the device 13–14 s, create
    14–15 s, the first step 16–16.5 s with the library 16.1–16.2 s inside it,
    and a step span 17–18 s, on the timeline's clock."""
    from yagi_tpu_torch import trace

    setup = [("yagi.device", 13 * S, 14 * S), ("yagi.qamrx.create", 14 * S, 15 * S),
             ("yagi.qamrx.first_step", 16 * S, 16 * S + S // 2),
             ("yagi.library", 16 * S + S // 10, 16 * S + S // 5)]
    spans = {n: {"count": 1, "ns": b - a, "self_ns": b - a} for n, a, b in setup}
    totals = {"spans": spans, "counters": {}, "launches": {},
              "timeline": {"anchor": {"wall_ns": 95 * S, "clock_ns": 5 * S}, "setup": setup,
                           "steps": [("yagi.qamrx.step", 17 * S, 18 * S)], "dropped": 0}}
    monkeypatch.setattr(trace, "snapshot", lambda: totals)
    monkeypatch.setattr(_setup_split, "_start", lambda: 100.0)
    rec = _record(10.0)
    assert _read("setup.before_program_s", rec) == pytest.approx(3.0)
    assert _read("setup.device_s", rec) == 1.0
    assert _read("setup.first_step_s", rec) == 0.5
    assert _read("setup.unspanned_s", rec) == pytest.approx(10.0 - 3.0 - 2.5)


def test_a_program_without_a_timeline_reads_nothing(monkeypatch):
    """The parent of the timeline: spans, counters and launches, no
    ``timeline``; and a port without the tracing module."""
    from yagi_tpu_torch import trace

    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": {}, "counters": {}, "launches": {}})
    for name in SPLIT:
        assert _read(name, _record(1.0)) is None
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # import raises
    for name in SPLIT:
        assert _read(name, _record(1.0)) is None


def _split_run(monkeypatch, cell, device):
    """A traced run of ``cell`` at its tiny size on ``device`` in a process
    where the program has made nothing yet, timed from this process's start
    as the command line times it; its four readings, its record and the
    program's snapshot."""
    from yagi_tpu_torch import trace
    from yagi_tpu_torch._src import device as device_mod

    records = []

    class Spy(runner.Record):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            records.append(self)

    monkeypatch.setattr(runner, "Record", Spy)
    monkeypatch.setattr(trace, "_firsts", set())
    monkeypatch.setattr(device_mod, "_opened", set())
    trace.reset()
    res = runner.run_cell(registry.benchmark(), cell, SEED, 0.3, True, device,
                          runner.process_start(), resize=TINY[cell])
    metrics = {k: v["value"] for k, v in res.line["metrics"].items()}
    return {name: metrics[name] for name in SPLIT}, records[0], trace.snapshot()


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_cpu_run_splits_its_setup(cell, monkeypatch):
    import torch

    parts, rec, snap = _split_run(monkeypatch, cell, torch.device("cpu"))
    assert all(v >= 0 for v in parts.values()), parts
    assert parts["setup.device_s"] == 0.0  # no context on the CPU
    assert parts["setup.first_step_s"] > 0
    tl = snap["timeline"]
    offset = tl["anchor"]["wall_ns"] - tl["anchor"]["clock_ns"]
    start = _setup_split._start()
    union = stats.covered([((a + offset) / 1e9, (b + offset) / 1e9) for _, a, b in tl["setup"]],
                          start, start + rec.setup_s)
    assert union > 0
    total = parts["setup.before_program_s"] + union + parts["setup.unspanned_s"]
    assert total == pytest.approx(rec.setup_s, abs=0.02)


@pytest.mark.card
def test_a_card_run_reads_the_context(monkeypatch, cuda_device):
    parts, rec, _ = _split_run(monkeypatch, "rxchain16.blk1m", cuda_device)
    assert parts["setup.device_s"] > 0
    assert all(v >= 0 for v in parts.values()), parts
    assert sum(parts.values()) <= rec.setup_s + 0.02  # the device and first step are in the union
