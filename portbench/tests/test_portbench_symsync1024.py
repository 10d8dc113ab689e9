"""The resampler → symbol synchronizer cell (``symsync1024.blk4k``) at a small
size: the check passes the program and fails a stale state, an altered
output, a count off by one and the control; the signal's cycle is seamless,
fixed by its seed and at its power; the loop locks onto the sent symbols;
the ``resamp.frame_mb`` reader. Its card tests run with
``python -m pytest portbench/tests -q -m card``."""

import math
import sys
import time

import numpy as np
import pytest
import torch

from portbench.core import registry, runner, window
from portbench.tests.helpers import SEED

CELL = "symsync1024.blk4k"
# 4 channels, 512-sample blocks of a 2048-sample cycle (991 symbols: 2.0666 samples a symbol)
TINY = {"channels": 4, "block": 512, "cycle_samples": 2048, "cycle_symbols": 991}
CPU = torch.device("cpu")


def _run(device=CPU, seconds=0.3, resize=TINY, **kw) -> runner.Result:
    return runner.run_cell(registry.benchmark(), CELL, SEED, seconds, kw.pop("trace", False),
                           device, time.time(), resize=resize, **kw)


def stale_state(step):
    """A step that returns its state unchanged."""
    def run(state, x):
        out, _ = step(state, x)
        return out, state
    return run


def altered_output(step):
    """One synchronizer output altered: channel 0's first slot."""
    def run(state, x):
        (y, valid, r, count), new = step(state, x)
        y = y.clone()
        y[0, 0, 0] += 0.5
        return (y, valid, r, count), new
    return run


def count_off_by_one(step):
    """The resampler's count handed on one too high."""
    def run(state, x):
        (y, valid, r, count), new = step(state, x)
        return (y, valid, r, count + 1), new
    return run


CASES = {"program": {}, "stale_state": {"step_wrapper": stale_state},
         "altered_output": {"step_wrapper": altered_output},
         "count_off_by_one": {"step_wrapper": count_off_by_one}, "control": {"control": True}}


@pytest.mark.parametrize("case", CASES)
def test_the_check_passes_the_program_and_fails_each_fault(case):
    res = _run(**CASES[case])
    assert res.correct is (case == "program"), res.checks
    assert set(res.checks) == {"count_errors", "resamp_gap", "slot_errors", "sym_gap",
                               "state_gap", "state_errors"}
    if case == "program":
        assert res.line["failed"] == 0 and res.line["attempted"] > 0
        assert all(value <= limit for value, limit in res.checks.values())
    elif case != "control":
        assert res.line["failed"] > 0


def _signal(**kw):
    cfg = {**registry.data("configs", "symsync1024"), "channels": TINY["channels"]}
    return cfg, {**TINY, **kw}, registry.module("signals", "qpsk_clock")


def _rrc(t: np.ndarray, sps: float, beta: float) -> np.ndarray:
    """The unit-energy RRC pulse of ``sps`` samples a symbol at t samples."""
    x = t / sps
    edge = np.abs(np.abs(4 * beta * x) - 1) < 1e-9
    xs = np.where((np.abs(x) < 1e-9) | edge, 0.25, x)  # any value off the removable points
    p = (np.sin(np.pi * xs * (1 - beta)) + 4 * beta * xs * np.cos(np.pi * xs * (1 + beta))) \
        / (np.pi * xs * (1 - (4 * beta * xs) ** 2))
    p = np.where(np.abs(x) < 1e-9, 1 - beta + 4 * beta / np.pi, p)
    p = np.where(edge, beta / np.sqrt(2) * ((1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                                            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))), p)
    return p / np.sqrt(sps)


def test_signal_cycle_is_seamless_and_the_stated_pulse():
    """At the cycle's last and first samples the signal is the time-domain sum
    Σ_k a_k·p(t − k·T − τ) over the repeated symbols (800 symbols each side;
    the RRC tails past them are below 1e-4): no seam where the cycle wraps."""
    cfg, wl, sig = _signal()
    prm = sig.params(cfg, wl, SEED)
    x = sig.clean(cfg, wl, prm, CPU)
    n, k = wl["cycle_samples"], wl["cycle_symbols"]
    sps = n / k
    assert x.abs().square().mean().item() == pytest.approx(1.0, rel=0.05)
    for c in range(cfg["channels"]):
        a = sig.table()[prm["symbols"][c]] * np.exp(1j * prm["phase"][c])
        ks = np.arange(-800, k + 800)
        for t in (n - 2, n - 1, 0, 1, 2):
            p = _rrc(t - ks * sps - prm["tau"][c] * sps, sps, cfg["beta"])
            want = np.sum(a[ks % k] * p) * np.sqrt(sps)  # unit power: √T per unit-energy pulse
            assert abs(x[c, t].item() - want) < 1e-3


def test_signal_is_fixed_by_its_seed_and_has_its_power():
    cfg, wl, sig = _signal()
    a = sig.make(cfg, wl, SEED, CPU)
    assert a.shape == (4, 4, 512) and a.dtype == torch.complex64
    assert torch.equal(a, sig.make(cfg, wl, SEED, CPU))
    assert not torch.equal(a, sig.make(cfg, wl, SEED + 1, CPU))
    sps = wl["cycle_samples"] / wl["cycle_symbols"]
    noise = sps * 10 ** (-sig.ES_N0_DB / 10)  # Es/N0 20 dB at Es = T
    assert a.abs().square().mean().item() == pytest.approx(1.0 + noise, rel=0.05)
    clean = sig.clean(cfg, wl, sig.params(cfg, wl, SEED), CPU)
    cycle = a.transpose(0, 1).reshape(4, -1)
    assert (cycle - clean).abs().square().mean().item() == pytest.approx(noise, rel=0.1)


def test_the_loop_locks_onto_the_sent_symbols():
    """After acquisition (the first 200 decisions), each channel's hard
    decisions, derotated by its carrier phase, are the sent symbols, cycled,
    from some offset and up to a rotation of the constellation."""
    from yagi_tpu_torch.chains import ResampSymsyncRx

    cfg, wl, sig = _signal(cycle_samples=4096, cycle_symbols=1982)
    prm = sig.params(cfg, wl, SEED)
    blocks = sig.make(cfg, wl, SEED, CPU)
    rx = ResampSymsyncRx.create(cfg["channels"], device=CPU)
    outs = []
    for x in torch.cat([blocks, blocks[:2]]):  # past the cycle's end: no seam to slip on
        y, valid, rx = rx.step(x)
        outs.append((y.reshape(4, -1), valid.reshape(4, -1)))
    k = wl["cycle_symbols"]
    for c in range(4):
        y = torch.cat([o[0][c][o[1][c]] for o in outs]).numpy()[200:]
        d = np.round(np.angle(y * np.exp(-1j * prm["phase"][c])) / (np.pi / 2) - 0.5) % 4
        sent = prm["symbols"][c].astype(np.int64)
        best = max(((off, rot) for off in range(k) for rot in range(4)),
                   key=lambda o: np.sum(d[:64] == (sent[(np.arange(64) + o[0]) % k] + o[1]) % 4))
        off, rot = best
        want = (sent[(np.arange(len(d)) + off) % k] + rot) % 4
        assert len(d) > k and np.array_equal(d, want), c


def _record():
    cfg = registry.data("configs", "symsync1024")
    wl = registry.data("workloads", CELL)
    return runner.Record(config=cfg, workload=wl, samples_per_block=1024 * wl["block"],
                         setup_s=1.0, window=window.Window(first=4, blocks=20), peaks=None)


def test_frame_mb_reader(monkeypatch):
    from yagi_tpu_torch import trace

    read = registry.module("layer_metrics", "resamp.frame_mb").read
    totals = {"spans": {}, "counters": {"resamp.calls": 4, "resamp.frame_bytes": 4 * 455999488},
              "launches": {}}
    monkeypatch.setattr(trace, "snapshot", lambda: totals)
    assert read(_record()) == pytest.approx(455.999488)
    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": {}, "counters": {}, "launches": {}})
    assert read(_record()) is None  # no call of the gather
    monkeypatch.setitem(sys.modules, "yagi_tpu_torch.trace", None)  # a port without tracing
    assert read(_record()) is None


def test_frame_mb_is_the_cells_gather():
    """1024 channels × the 3976 outputs' capacity × 14 taps × 8 bytes."""
    from yagi_tpu_torch.filter import MsResamp

    cfg = registry.data("configs", "symsync1024")
    ms = MsResamp.create(cfg["rate"], batch_shape=(1,), device=CPU)
    cap = ms.out_capacity(registry.data("workloads", CELL)["block"])
    assert cap == 3976 and ms.arbitrary.sub_len == 14
    assert math.isclose(cfg["channels"] * cap * 14 * 8 / 1e6, 455.999488)


def test_a_traced_cpu_run_reads_the_frames():
    tiny = {**TINY, "trace_steps": 2}
    line = _run(trace=True, resize=tiny).line
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    cap = 504  # 512 samples (+ 1 of the decimator's buffer) at 0.968, + 4, to a multiple of 8
    assert metrics["resamp.frame_mb"] == pytest.approx(4 * cap * 14 * 8 / 1e6)
    assert line["correct"]


@pytest.mark.card
def test_cell_is_correct_and_reads_its_layers_on_the_card(cuda_device):
    res = _run(device=cuda_device, trace=True, seconds=1.0, resize={"channels": 64})
    assert res.correct, res.checks
    metrics = {k: v["value"] for k, v in res.line["metrics"].items()}
    want = {m["name"] for m in registry.metrics_of(registry.benchmark(), CELL, True)}
    assert set(metrics) == want
    assert metrics["resamp.frame_mb"] == pytest.approx(64 * 3976 * 14 * 8 / 1e6)


@pytest.mark.card
def test_control_is_not_correct_on_the_card(cuda_device):
    assert not _run(device=cuda_device, control=True, resize={"channels": 64}).correct
