"""The FM-band channelizer cell (``chz64fm.blk16m``) at a small size: the
check passes the program and fails a stale state, an altered output and the
control; the signal's phase steps and its seed; K2's work count against
``chip_smoke.py``'s; the cell's two readers. Its card tests run with
``python -m pytest portbench/tests -q -m card``."""

import math
import sys
import time

import pytest
import torch

from portbench.core import registry, runner, window
from portbench.tests.helpers import SEED

CELL = "chz64fm.blk16m"
TINY = {"block": 512, "cycle_blocks": 4}  # 512 steps of 64 channels a block (N = 32,768)


def _run(device=torch.device("cpu"), seconds=0.3, **kw) -> runner.Result:
    return runner.run_cell(registry.benchmark(), CELL, SEED, seconds, kw.pop("trace", False),
                           device, time.time(), resize=TINY, **kw)


def stale_state(step):
    """A step that returns its state unchanged."""
    def run(state, x):
        out, _ = step(state, x)
        return out, state
    return run


def altered_output(step):
    """One discriminator output altered: step 0 of channel 0."""
    def run(state, x):
        (yr, yi, fm), new = step(state, x)
        fm = fm.clone()
        fm[0, 0] += 1.0
        return (yr, yi, fm), new
    return run


CASES = {"program": {}, "stale_state": {"step_wrapper": stale_state},
         "altered_output": {"step_wrapper": altered_output}, "control": {"control": True}}


@pytest.mark.parametrize("case", CASES)
def test_the_check_passes_the_program_and_fails_each_fault(case):
    res = _run(**CASES[case])
    assert res.correct is (case == "program"), res.checks
    assert set(res.checks) == {"chan_gap", "fm_gap", "state_gap", "state_errors"}
    if case == "program":
        assert res.line["failed"] == 0 and res.line["attempted"] > 0
        assert all(value <= limit for value, limit in res.checks.values())
    elif case != "control":
        assert res.line["failed"] > 0


def _signal():
    return registry.data("configs", "chz64fm"), dict(TINY), registry.module("signals", "fmband")


def test_signal_phase_steps_stay_within_0_2_pi_and_close_the_cycle():
    cfg, wl, sig = _signal()
    tones = sig.messages(cfg, wl, SEED)
    steps = wl["block"] * wl["cycle_blocks"]
    dphi = sig.phase_steps(cfg, wl, tones, 0, steps, torch.device("cpu"))
    assert dphi.shape == (steps, 64)
    assert dphi.abs().max() <= 2 * math.pi * cfg["kf"] + 1e-12
    assert dphi.abs().max() > 0.5 * 2 * math.pi * cfg["kf"]  # the messages use their range
    assert dphi.sum(0).abs().max() < 1e-9  # whole cycles: no phase seam where the cycle wraps
    assert torch.equal(sig.phase_steps(cfg, wl, tones, steps, 8, torch.device("cpu")), dphi[:8])


def test_signal_is_fixed_by_its_seed_and_has_its_power():
    cfg, wl, sig = _signal()
    a = sig.make(cfg, wl, SEED, torch.device("cpu"))
    assert a.shape == (4, 2, 64 * 512) and a.dtype == torch.float32
    assert torch.equal(a, sig.make(cfg, wl, SEED, torch.device("cpu")))
    assert not torch.equal(a, sig.make(cfg, wl, SEED + 1, torch.device("cpu")))
    power = a.square().sum(1).mean().item()  # the carriers' 1, the noise's 1e-3 of a carrier
    assert power == pytest.approx(1.0 + 1e-3 / 64, rel=0.02)


def test_work_count_matches_chip_smoke_at_config4():
    import chip_smoke

    from yagi_tpu_torch.tools.paths import T4

    want = chip_smoke.kernel_work(torch.device("cpu"), 0.0)["channelizer_fp32"]
    cfg = registry.data("configs", "chz64fm")
    got = registry.module("work", "channelizer").work(cfg, {"block": T4}, {})
    assert got == tuple(float(v) for v in want)


def _record(slice_=None, warmup=4, blocks=20):
    cfg = registry.data("configs", "chz64fm")
    wl = {**registry.data("workloads", CELL), "warmup_blocks": warmup}
    peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
    return runner.Record(config=cfg, workload=wl, samples_per_block=64 * wl["block"],
                         setup_s=1.0, window=window.Window(first=warmup, blocks=blocks),
                         peaks=peaks, slice=slice_)


def _read(name, rec):
    return registry.module("layer_metrics", name).read(rec)


def test_roofline_reader():
    from portbench.core.trace import Op, Slice

    ops = [Op("void (anonymous namespace)::channelizer_fp32_kernel(float const*)", 0.0, 2e-4),
           Op("void (anonymous namespace)::channelizer_fp32_kernel(float const*)", 1e-3, 1.2e-3),
           Op("void at::native::vectorized_elementwise_kernel<4>", 2e-4, 9e-4)]
    rec = _record(Slice(ops=ops, spans=[], lo=0.0, hi=2e-3, steps=2))
    nbytes, _ = rec.work("channelizer")
    assert _read("kernel.channelizer.roofline_pct", rec) == pytest.approx(
        100 * nbytes / 3.35e12 / 2e-4)
    assert _read("kernel.channelizer.roofline_pct", _record()) is None  # no trace
    tiled = [Op("channelizer_tiled_kernel", 0.0, 1e-3)]
    assert _read("kernel.channelizer.roofline_pct",
                 _record(Slice(ops=tiled, spans=[], lo=0.0, hi=1e-3, steps=1))) > 0


def test_glue_leaves_k2_out():
    """K2's two instances are the port's own kernels, so ``glue.device_ms``
    reads the discriminator and the copies alone."""
    from portbench.core.trace import Op, Slice

    ops = [Op("(anonymous namespace)::channelizer_fp32_kernel(float const*, float const*)",
              0.0, 1e-4),
           Op("void at::native::vectorized_elementwise_kernel<4, at::native::atan2_kernel>",
              1e-4, 1.5e-4)]
    rec = _record(Slice(ops=ops, spans=[], lo=0.0, hi=2e-4, steps=1))
    rec.port_kernels = runner.port_kernel_names()
    assert {"channelizer_fp32_kernel", "channelizer_tiled_kernel"} <= set(rec.port_kernels)
    assert _read("glue.device_ms", rec) == pytest.approx(0.05)


def test_launches_reader(monkeypatch):
    from yagi_tpu_torch import trace

    totals = {"spans": {}, "counters": {},
              "launches": {"fused_channelizer_apply": 24, "fused_chain_apply": 5}}
    monkeypatch.setattr(trace, "snapshot", lambda: totals)
    assert _read("kernel.channelizer.launches_per_step", _record()) == 1.0  # 24 over 4 + 20 steps
    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": {}, "counters": {}, "launches": {}})
    assert _read("kernel.channelizer.launches_per_step", _record()) == 0.0
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # a port without tracing
    assert _read("kernel.channelizer.launches_per_step", _record()) is None


def test_a_traced_cpu_run_reads_no_launch():
    line = _run(trace=True).line
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["kernel.channelizer.launches_per_step"] == 0.0  # the CPU route
    assert "kernel.channelizer.roofline_pct" not in metrics  # no device trace on the CPU


@pytest.mark.card
def test_cell_is_correct_and_reads_its_layers_on_the_card(cuda_device):
    res = _run(device=cuda_device, trace=True, seconds=1.0)
    assert res.correct, res.checks
    metrics = {k: v["value"] for k, v in res.line["metrics"].items()}
    want = {m["name"] for m in registry.metrics_of(registry.benchmark(), CELL, True)}
    assert set(metrics) == want
    assert 0 < metrics["kernel.channelizer.roofline_pct"] <= 105
    assert metrics["kernel.channelizer.launches_per_step"] == 1.0


@pytest.mark.card
def test_control_is_not_correct_on_the_card(cuda_device):
    assert not _run(device=cuda_device, control=True).correct
