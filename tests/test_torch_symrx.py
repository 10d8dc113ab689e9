"""ResampSymsyncRx (config[1]: MsResamp at 2/2.0663 → Symsync at k_out = 1,
the resampler's count handed on as a device tensor) on the CPU route:
against the benchmark's plain reference (``portbench/reference/symsync_rx.py``)
on the cell's signal and on noise, against yagi_tpu's ``bench.py:160-192``
composition, three blocks against one long block, no host read of the count,
its spans and counters, and its bad parameters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench.core import registry
from portbench.reference import symsync_rx as ref
from yagi_tpu.design import FirFilterShape as JShape
from yagi_tpu.filter import MsResamp as JMsResamp
from yagi_tpu.filter import Symsync as JSymsync
from yagi_tpu_torch import trace
from yagi_tpu_torch.chains import ResampSymsyncRx
from yagi_tpu_torch.errors import ConfigError

torch.set_num_threads(1)

DEV = "cpu"
C, T, BLOCKS = 8, 1024, 3  # channels, samples a block, blocks a stream
CFG = {**registry.data("configs", "symsync1024"), "channels": C}
# the cell's signal cut to a 3-block cycle: 3072 / 1487 = 2.0659 samples a symbol
WL = {"block": T, "cycle_samples": BLOCKS * T, "cycle_symbols": 1487}
VIEW = registry.module("drivers", "symsync_rx").Driver.view
TOL = 1e-4  # yagi_tpu's tests/test_symscan.py fused-kernel tolerance, of max(|y|, 1)
SPANS = ("yagi.symrx.resamp", "yagi.symsync.run", "yagi.symrx.state")
HOST_READS = ("item", "tolist", "numpy", "__int__", "__index__", "__bool__", "__float__",
              "__complex__")


def _qpsk(seed):
    return list(registry.module("signals", "qpsk_clock").make(CFG, WL, seed, torch.device(DEV)))


def _noise(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BLOCKS, C, T)) + 1j * rng.standard_normal((BLOCKS, C, T))
    return list(torch.from_numpy(x.astype(np.complex64)))


def _create():
    return ResampSymsyncRx.create(C, device=DEV)


def _stream(rx, blocks):
    outs = []
    for x in blocks:
        y, valid, rx = rx.step(x)
        outs.append((y, valid))
    return outs, rx


def _compact(y, valid):
    """Each channel's valid outputs in stream order, one list a channel."""
    y, valid = y.reshape(C, -1), valid.reshape(C, -1)
    return [y[c][valid[c]] for c in range(C)]


@pytest.fixture(autouse=True)
def clean_trace():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.mark.parametrize("signal", [_qpsk, _noise], ids=["qpsk_clock", "noise"])
def test_entry_against_the_plain_reference(signal):
    """Within the cell's limits (``configs/symsync1024.json``), block after
    block from the entry's own state (the first from the reference's initial
    state, which the entry's equals): the count and u32 phase exact, the
    resampler's float32 sums within 1e-5 of the float64 ones, the
    synchronizer's masks, outputs and state bit for bit (the same loop in the
    same order on the same resampled samples)."""
    const = ref.sync_constants(CFG, DEV)
    init = ref.initial_state(CFG, C, DEV)
    assert ref.compare_state(VIEW(_create()), init) == {"state_gap": 0.0, "state_errors": 0}
    rx = _create()
    for i, x in enumerate(signal(7)):
        before = VIEW(rx)
        y, valid, r, count, rx = rx.step_full(x)
        row, _ = ref.block_row(x, init if i == 0 else before, (y, valid, r, count), VIEW(rx),
                               CFG, const)
        assert all(row[k] <= lim for k, lim in CFG["limits"].items()), row
        assert row["sym_gap"] == row["state_gap"] == 0.0 and row["resamp_gap"] < 1e-6


def test_entry_against_yagi_tpus_composition():
    """bench.py:160-192's step, ``ms.execute_block`` then
    ``ss.execute_slots(y, n_valid=cnt)``, against the entry over three
    carried blocks of noise: the counts and masks equal, the slots within
    yagi_tpu's tolerance, τ within 1e-4."""
    j_ms = JMsResamp.create(2.0 / 2.0663, batch_shape=(C,), arbitrary_interp="farrow")
    j_ss = JSymsync.create_rnyquist(JShape.RRCOS, 2, 7, 0.3, batch_shape=(C,)).set_lf_bw(0.02)
    rx = _create()
    for x in _noise(3):
        yj, kj, j_ms = j_ms.execute_block(jnp.asarray(x.numpy()))
        sj, vj, j_ss = j_ss.execute_slots(yj, n_valid=kj)
        y, valid, _, count, rx = rx.step_full(x)
        assert int(count) == int(np.asarray(kj))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
        sj = np.asarray(sj)
        assert np.abs(y.numpy() - sj).max() <= TOL * max(1.0, np.abs(sj).max())
        np.testing.assert_allclose(rx.sync.tau.numpy(), np.asarray(j_ss.tau), atol=1e-4)
        assert int(rx.resamp.arbitrary.phase) == int(np.asarray(j_ms.arbitrary.phase))


def test_three_blocks_equal_one_long_block():
    """Bit for bit: each resampler output is a 14-tap dot of its own frame
    and each synchronizer dot sums its own 28 samples in one order, however
    long the block, and the loop carries its whole state."""
    blocks = _qpsk(11)
    outs, rx3 = _stream(_create(), blocks)
    y1, v1, rx1 = _create().step(torch.cat(blocks, dim=1))
    split = [torch.cat(parts) for parts in zip(*(_compact(y, v) for y, v in outs))]
    for got, want in zip(split, _compact(y1, v1)):
        assert torch.equal(got, want)
    for key, value in VIEW(rx1).items():
        assert torch.equal(value, VIEW(rx3)[key]), key


def _forbid_host_reads(monkeypatch):
    def read(*_):
        raise AssertionError("a host read of a tensor inside the step")

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, read)


def _reads_count(rx, x):
    _, _, _, count, new = rx.step_full(x)
    int(count)
    return new


@pytest.mark.parametrize("step", ["entry", "reads_count"])
def test_no_host_read_of_the_count(monkeypatch, step):
    """The step makes no host read (``item``, ``int``, ``bool``, ... of any
    tensor), so on the card it never waits on the device: the count stays a
    0-d tensor from the resampler into the synchronizer. The guard catches
    a step that reads the count."""
    rx = _create()
    blocks = _noise(5)
    _forbid_host_reads(monkeypatch)
    if step == "entry":
        for x in blocks:
            y, valid, rx = rx.step(x)
        monkeypatch.undo()
        assert valid.any() and rx.resamp.arbitrary.phase.dim() == 0
    else:
        with pytest.raises(AssertionError, match="host read"):
            _reads_count(rx, blocks[0])


def test_spans_and_counters():
    """step ⊃ resamp, symsync.run, state; the resampler's counters count the
    u32 gather's calls and frame bytes, C·cap·L·8, on or off."""
    rx = _create()
    assert trace.snapshot()["spans"]["yagi.symrx.create"]["count"] == 1  # timed with tracing off
    cap = rx.resamp.arbitrary.out_capacity(T + 1)  # the decimation path's buffer of n + 1
    frame = C * cap * rx.resamp.arbitrary.sub_len * 8
    blocks = _noise(2)
    rx = rx.step(blocks[0])[2]  # tracing off: no span, the counters count
    snap = trace.snapshot()
    assert "yagi.symrx.step" not in snap["spans"]
    assert snap["counters"]["resamp.calls"] == 1 and snap["counters"]["resamp.frame_bytes"] == frame
    trace.reset()
    trace.enable()
    for x in blocks[1:]:
        rx = rx.step(x)[2]
    snap = trace.snapshot()
    spans = snap["spans"]
    step = spans["yagi.symrx.step"]
    assert step["count"] == 2 and all(spans[s]["count"] == 2 for s in SPANS)
    assert step["self_ns"] == step["ns"] - sum(spans[s]["ns"] for s in SPANS)
    assert snap["counters"]["resamp.calls"] == 2
    assert snap["counters"]["resamp.frame_bytes"] == 2 * frame
    assert cap == 1000 and rx.resamp.arbitrary.sub_len == 14


def test_outputs_and_state_are_the_same_with_tracing_on_and_off():
    blocks = _noise(4)
    results = []
    for on in (False, True):
        trace.enable(on)
        results.append(_stream(_create(), blocks))
    (outs0, rx0), (outs1, rx1) = results
    assert all(torch.equal(a, b) for o0, o1 in zip(outs0, outs1) for a, b in zip(o0, o1))
    assert all(torch.equal(v, VIEW(rx1)[k]) for k, v in VIEW(rx0).items())


def test_create_builds_the_two_objects_of_the_configuration():
    rx = _create()
    assert rx.resamp.num_halfband_stages == 0 and not rx.resamp.interp
    assert rx.resamp.arbitrary.npfb == 256 and int(rx.resamp.arbitrary.step) == ref.resamp_step(CFG)
    assert (rx.sync.k, rx.sync.k_out, rx.sync.npfb) == (2, 1, 32)
    assert torch.equal(rx.sync.taps(), ref.sync_constants(CFG, DEV)["g"])
    two = ResampSymsyncRx.create(C, k_out=2, device=DEV)
    assert two.sync.k_out == 2 and float(two.sync.rate[0]) == 1.0


@pytest.mark.parametrize("kw", [{"channels": 0}, {"rate": 0.0}, {"k": 1}, {"beta": 1.5},
                                {"lf_bw": 2.0}, {"k_out": 0}, {"npfb": 0}, {"as_": 0.0}],
                         ids=lambda kw: next(iter(kw)))
def test_bad_parameters_raise(kw):
    with pytest.raises(ConfigError):
        ResampSymsyncRx.create(**{"channels": C, **kw}, device=DEV)
