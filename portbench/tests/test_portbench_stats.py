"""The harness's arithmetic against hand counts: the percentile, the union
of device intervals and its gaps, the idle gaps by host span, the work
counts and their bound."""

import pytest

from portbench.core import registry, stats
from portbench.core.trace import Op, Slice
from portbench.core.window import ENTRY, WAIT

H100 = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def test_percentile_is_the_nearest_rank():
    assert stats.percentile(list(range(1, 21)), 95) == 19  # ceil(0.95·20) = 19th
    assert stats.percentile(list(range(100, 0, -1)), 95) == 95
    assert stats.percentile([5.0, 1.0, 3.0], 95) == 5.0  # ceil(2.85) = 3rd
    assert stats.percentile([2.0], 95) == 2.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_cover_and_gaps():
    iv = [(1.0, 3.0), (5.0, 6.0), (0.0, 2.0)]
    assert stats.union(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert stats.covered(iv, 0.0, 10.0) == 4.0
    assert stats.covered(iv, 1.0, 5.5) == 2.5
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert stats.gaps(iv, -1.0, 5.5) == [(-1.0, 0.0), (3.0, 5.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_idle_gaps_are_named_by_the_host_span():
    sl = Slice(ops=[Op("k1", 0.0, 1.0), Op("k2", 2.0, 3.0), Op("k1", 2.5, 3.5)],
               spans=[(ENTRY, 0.5, 2.5), (WAIT, 3.8, 4.2)], lo=0.0, hi=5.0, steps=2)
    assert sl.busy_s() == 2.5
    # the gap (1, 2) lies in the entry; of (3.5, 5), 0.4 in a wait and 1.1 in no span
    assert sl.idle_gaps() == [("harness", 1.5), ("entry", 1.0)]
    sl.spans.append((WAIT, 4.2, 5.0))
    assert sl.idle_gaps()[0] == ("wait", 1.5)
    assert sl.by_name() == [("k1", 2.0), ("k2", 1.0)]
    assert sl.breakdown()["device_ops"] == [["k1", 2.0], ["k2", 1.0]]


def _work(function, cfg, wl, info=None):
    return registry.module("work", function).work(cfg, wl, info or {})


def test_chain_work_at_the_long_block():
    cfg = registry.data("configs", "rxchain16")
    wl = registry.data("workloads", "rxchain16.blk1m")
    nbytes, ops = _work("chain", cfg, wl)
    # in 16·2^20·8, out 16·2^21·8, taps 2·77·4, history 2·16·128·4
    assert nbytes == 134217728 + 268435456 + 616 + 16384
    # per input 4·64, per output (2 a sample) 4·14 + 8
    assert ops == 16 * 2**20 * (256 + 2 * 64)
    assert stats.bound_s((nbytes, ops), H100) == nbytes / 3.35e12  # bytes bound it


def test_loop_work_at_the_long_block():
    cfg = registry.data("configs", "qamrx2048")
    wl = registry.data("workloads", "qamrx2048.blk4k")
    assert _work("agc", cfg, wl) == (2048 * 4096 * 16 + 2048 * 64, 2048 * 4096 * 14)
    eq_state = 2048 * (8 * 7 + 8 * 7 + 4 * 7 + 28)
    assert _work("qam_eq", cfg, wl) == (2048 * 8192 * 26 + 2 * eq_state + 16 * 8 + 2048 * 12,
                                        2048 * 8192 * (56 + 80 + 70 + 30))
    assert _work("symsync", cfg, wl) is None  # no emissions counted
    emitted = 2048 * 4096
    nbytes, ops = _work("symsync", cfg, wl, {"emitted_per_block": emitted})
    L = 28  # 897 taps over 32 branches
    assert nbytes == 2048 * (4096 + L) * 8 + 64 * L * 4 + 2048 * 4096 * 18 + 2048 * 72 + 2048 * 4
    assert ops == emitted * 8 * L + 2048 * 4096 * 2 * 20
