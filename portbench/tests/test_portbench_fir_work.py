"""``work/fir.py`` at config[2]'s shapes (512 × 16,384, 129 taps): the mean
of the four FIRs' least work a call, its bound at the card's peaks (the
operations bound it: 0.0484 ms a call, 0.194 ms a step), and the reader of
``kernel.fir.roofline_pct`` silent without a trace."""

import pytest

from portbench.core import registry, runner, stats

CELL = "fmstereo512.blk16k"
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def _work():
    wl = registry.data("workloads", CELL)
    cfg = registry.data("configs", wl["config"])
    return registry.module("work", "fir").work(cfg, wl, {})


def test_fir_work_at_config2():
    """Operations 2·C·T·L·(2 + 1 + 1 + 2)/4 a call; bytes a call the mean of
    the pilot's real block in and complex out, the delay's and the sum's
    real in and out, the difference's complex in and out, with each one's
    128 window samples and taps."""
    nbytes, ops = _work()
    C, T, L = 512, 16384, 129
    assert ops == 2 * C * T * L * 6 / 4
    want = (C * (T + L - 1) * (4 + 4 + 4 + 8) + C * T * (8 + 4 + 4 + 8) + L * (8 + 4 + 4 + 4)) / 4
    assert nbytes == want
    bound = stats.bound_s((nbytes, ops), PEAKS)
    assert bound == ops / PEAKS["fp32_flops_per_s"] and bound == pytest.approx(4.845e-5, rel=1e-3)
    assert 4 * bound == pytest.approx(1.938e-4, rel=1e-3)  # a step's four calls


def test_the_reader_is_silent_without_a_trace():
    class Rec:
        def roofline_pct(self, pattern, function):
            assert pattern == r"\bfir_block_kernel\b" and function == "fir"
            return None

    assert registry.module("layer_metrics", "kernel.fir.roofline_pct").read(Rec()) is None


def test_the_metric_is_listed_for_the_cell():
    bench = registry.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == "kernel.fir.roofline_pct")
    assert entry["workloads"] == [CELL] and entry["layer"] == "kernels"
    assert entry["moves"] == "msps" and entry["source"] == "device_trace"
    assert "kernel.fir.roofline_pct" in {m["name"] for m in registry.metrics_of(bench, CELL, True)}
    assert "fir_block_kernel" in runner.port_kernel_names()  # a csrc kernel: not glue
