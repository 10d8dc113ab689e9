"""The reader of ``resamp.kernel_share``: the launches of ``resamp_u32_apply``
over the program's counter ``resamp.calls`` where it keeps both, nothing
where it has no such launch count (a program before the kernel), made no
call, or keeps no totals at all; and a CPU run's share, 0, where the plain
version serves every call."""

import sys

import torch

from portbench.core import registry, runner, window

NAME = "resamp.kernel_share"


def _read(rec=None):
    return registry.module("layer_metrics", NAME).read(rec)


def _totals(counters, launches):
    return {"spans": {}, "counters": counters, "launches": launches}


def test_launches_over_calls_where_the_program_counts_both(monkeypatch):
    from yagi_tpu_torch import trace

    for launches, calls in ((24, 24), (0, 24), (12, 24)):
        totals = _totals({"resamp.calls": calls, "resamp.frame_bytes": 0},
                         {"resamp_u32_apply": launches, "symsync_fused_apply": 24})
        monkeypatch.setattr(trace, "snapshot", lambda t=totals: t)
        assert _read() == launches / calls


def test_nothing_without_the_launch_count_or_a_call(monkeypatch):
    from yagi_tpu_torch import trace

    for counters, launches in (({"resamp.calls": 24}, {"symsync_fused_apply": 24}),
                               ({}, {"resamp_u32_apply": 0}),
                               ({"resamp.calls": 0}, {"resamp_u32_apply": 0})):
        monkeypatch.setattr(trace, "snapshot", lambda c=counters, n=launches: _totals(c, n))
        assert _read() is None
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # import raises
    assert _read() is None


def test_a_cpu_run_reads_no_kernel():
    from yagi_tpu_torch.filter import Resamp

    rec = runner.Record(config={}, workload={"warmup_blocks": 1}, samples_per_block=1,
                        setup_s=1.0, window=window.Window(first=1, blocks=1), peaks=None)
    rs = Resamp.create(0.9, batch_shape=(2,), device="cpu")
    rs.execute_block_n(torch.zeros(2, 64, dtype=torch.complex64), 64)
    assert _read(rec) == 0
