"""The FM stereo decoder cell (``fmstereo512.blk16k``) at a small size: the
configuration and cell load; the driver's view names what the reference
reads; the reference cut in two equals itself whole; the check passes the
program and fails a stale state, an altered output and the control; the
readers of the FIRs' counters and the de-emphasis's work. Its card tests run
with ``python -m pytest portbench/tests -q -m card``."""

import sys
import time

import pytest
import torch

from portbench.core import registry, runner, stats, window
from portbench.tests.helpers import SEED

CELL = "fmstereo512.blk16k"
TINY = {"channels": 4, "block": 1024}  # 4 stations, an 8-block cycle of 8192 samples
CPU = torch.device("cpu")
REF = registry.module("reference", "fm_stereo")


def _run(device=CPU, seconds=0.3, resize=TINY, **kw) -> runner.Result:
    return runner.run_cell(registry.benchmark(), CELL, SEED, seconds, kw.pop("trace", False),
                           device, time.time(), resize=resize, **kw)


def _tiny():
    cfg = {**registry.data("configs", "fmstereo512"), "channels": TINY["channels"]}
    return cfg, {**registry.data("workloads", CELL), "block": TINY["block"]}


def test_config_and_cell_load():
    bench = registry.benchmark()
    entry = registry.cell(bench, CELL)
    cfg = registry.data("configs", entry["config"])
    wl = registry.data("workloads", CELL)
    assert entry["chips"] == 1 and wl["config"] == cfg["name"] == "fmstereo512"
    assert (cfg["channels"], wl["block"], wl["cycle_blocks"], wl["in_flight"]) == (512, 16384, 8, 2)
    assert wl["cycle_blocks"] * cfg["channels"] * wl["block"] * 8 == 512 << 20
    assert (cfg["kf"], cfg["f_pilot"], cfg["f_audio"], cfg["n_taps"]) == (0.5, 0.095, 0.075, 129)
    assert cfg["deemph_alpha"] == pytest.approx(0.064493, abs=5e-7) and cfg["reduced"] == []
    layers = {m["name"] for m in registry.metrics_of(bench, CELL, True)}
    assert {"fir.frame_mb", "fir.mac_share", "kernel.iir.roofline_pct", "dispatch.host_ms",
            "dispatch.ops_per_step", "glue.device_ms", "device.idle_pct"} <= layers


def test_the_view_names_what_the_reference_reads():
    from yagi_tpu_torch.chains import FmStereoRx

    cfg, _ = _tiny()
    view = registry.module("drivers", "fm_stereo").Driver.view(
        FmStereoRx.create(batch_shape=(4,), device=CPU))
    d = REF.decode(cfg, torch.zeros((4, 300), dtype=torch.complex64), view)
    assert set(view) == set(REF.tails(cfg, d)) | {"r_prime"}


def test_the_graph_copies_back_the_fields_the_view_names():
    """The driver's state walk: rebuilt from its own leaves a state is the
    same, and the leaves a step replaces (those the graph copies back into
    its input and clones out) are the tensors the view names."""
    from yagi_tpu_torch.chains import FmStereoRx

    drv = registry.module("drivers", "fm_stereo")
    cfg, wl = _tiny()
    rx = FmStereoRx.create(batch_shape=(4,), device=CPU)
    leaves = drv._leaves(rx)
    assert all(a is b for a, b in zip(drv._leaves(drv._rebuild(rx, iter(leaves))), leaves))
    x = registry.module("signals", "fmstereo").make(cfg, wl, SEED, CPU)[0]
    new = rx.step(x)[3]
    moved = {id(t) for t, s in zip(drv._leaves(new), leaves) if t is not s}
    assert moved == {id(t) for t in drv.Driver.view(new).values()}


def test_the_reference_cut_in_two_equals_it_whole():
    """The reference's own block invariance: a block from a state equals its
    two parts, the second from the first's carried state."""
    cfg, wl = _tiny()
    blocks = registry.module("signals", "fmstereo").make(cfg, wl, SEED, CPU)
    L = cfg["n_taps"]
    zeros = {"r_prime": torch.zeros(4, dtype=torch.complex64), "align_w": torch.zeros(4, L),
             "pilot_w": torch.zeros(4, L, dtype=torch.complex64), "mono_w": torch.zeros(4, L),
             "diff_w": torch.zeros(4, L, dtype=torch.complex64), "deemph_l": torch.zeros(4, 1),
             "deemph_r": torch.zeros(4, 1)}
    st = {**REF.tails(cfg, REF.decode(cfg, blocks[0], zeros)), "r_prime": blocks[0][:, -1]}
    x = blocks[1]
    whole = REF.decode(cfg, x, st)
    a = REF.decode(cfg, x[:, :400], st)
    b = REF.decode(cfg, x[:, 400:], {**REF.tails(cfg, a), "r_prime": x[:, 399]})
    for k in ("left", "right", "m", "md", "dx"):
        got = torch.cat([a[k], b[k]], dim=-1)
        assert (got - whole[k]).abs().max().item() < 1e-12, k


def stale_state(step):
    """A step that returns its state unchanged."""
    def run(state, x):
        out, _ = step(state, x)
        return out, state
    return run


def altered_output(step):
    """One audio sample altered: station 0's first left sample."""
    def run(state, x):
        (left, right, level), new = step(state, x)
        left = left.clone()
        left[0, 0] += 0.01
        return (left, right, level), new
    return run


CASES = {"program": {}, "stale_state": {"step_wrapper": stale_state},
         "altered_output": {"step_wrapper": altered_output}, "control": {"control": True}}


@pytest.mark.parametrize("case", CASES)
def test_the_check_passes_the_program_and_fails_each_fault(case):
    res = _run(**CASES[case])
    assert res.correct is (case == "program"), res.checks
    assert set(res.checks) == {"left_gap", "right_gap", "pilot_gap", "state_gap",
                               "state_errors"}
    if case == "program":
        assert res.line["failed"] == 0 and res.line["attempted"] > 0
    elif case != "control":
        assert res.line["failed"] > 0


def _record(blocks=20):
    cfg = registry.data("configs", "fmstereo512")
    wl = registry.data("workloads", CELL)
    return runner.Record(config=cfg, workload=wl, samples_per_block=512 * wl["block"],
                         setup_s=1.0, window=window.Window(first=4, blocks=blocks), peaks=None)


def test_fir_readers(monkeypatch):
    from yagi_tpu_torch import trace

    frame = registry.module("layer_metrics", "fir.frame_mb").read
    share = registry.module("layer_metrics", "fir.mac_share").read
    totals = {"spans": {}, "launches": {},
              "counters": {"conv.frame_bytes": 24 * 402653184, "fmrx.steps": 24,
                           "conv.macs": 1000, "conv.tap_macs": 504}}
    monkeypatch.setattr(trace, "snapshot", lambda: totals)
    assert frame(_record()) == pytest.approx(402.653184)  # 24 calls of the step
    assert share(_record()) == pytest.approx(0.504)
    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": {}, "counters": {}, "launches": {}})
    assert frame(_record()) is None and share(_record()) is None  # a program before the counters
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # a port without tracing
    assert frame(_record()) is None and share(_record()) is None


def test_frame_mb_is_the_cells_four_filters():
    """A step's frames at 512 × 16,384: 128 rows of 256 samples a station for
    the pilot's complex matmul (8 bytes), the delay's and the sum's real ones
    and the difference's two real halves (4 bytes each)."""
    assert 512 * 128 * 256 * (8 + 4 + 4 + 2 * 4) / 1e6 == pytest.approx(402.653184)


def test_iir_work_and_bound_at_the_cell():
    """C·T·4 bytes in and out a filter, 4 operations a sample: 0.0200 ms at
    3.35 TB/s (the bytes bound it)."""
    rec = _record()
    nbytes, ops = rec.work("iir")
    assert nbytes == pytest.approx(2 * 512 * 16384 * 4, rel=1e-4) and ops == 4 * 512 * 16384
    peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
    assert stats.bound_s((nbytes, ops), peaks) == pytest.approx(2.0e-5, rel=0.005)


def test_a_traced_cpu_run_reads_the_fir_counters():
    from yagi_tpu_torch import trace

    trace.reset()
    line = _run(trace=True, resize={**TINY, "trace_steps": 2}).line
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["fir.frame_mb"] == pytest.approx(4 * 8 * 256 * (8 + 4 + 4 + 2 * 4) / 1e6)
    assert metrics["fir.mac_share"] == pytest.approx(129 / 256)
    assert "kernel.iir.roofline_pct" not in metrics  # no device trace on the CPU
    assert line["correct"]


@pytest.mark.card
def test_cell_is_correct_and_reads_its_layers_on_the_card(cuda_device):
    from yagi_tpu_torch import trace

    trace.reset()
    res = _run(device=cuda_device, trace=True, seconds=1.0, resize={"channels": 64})
    assert res.correct, res.checks
    metrics = {k: v["value"] for k, v in res.line["metrics"].items()}
    want = {m["name"] for m in registry.metrics_of(registry.benchmark(), CELL, True)}
    assert set(metrics) == want
    assert metrics["fir.frame_mb"] == pytest.approx(64 * 128 * 256 * 24 / 1e6)
    assert metrics["fir.mac_share"] == pytest.approx(129 / 256)
    assert 0 < metrics["kernel.iir.roofline_pct"] <= 105


@pytest.mark.card
def test_control_is_not_correct_on_the_card(cuda_device):
    assert not _run(device=cuda_device, control=True, resize={"channels": 64}).correct
