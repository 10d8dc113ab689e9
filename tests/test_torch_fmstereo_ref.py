"""FmStereoRx (config[2]: Freqdem → four 129-tap FIRs as banded matmuls →
the pilot's 38 kHz subcarrier → two first-order de-emphasis IIRs) on the CPU
route: against the benchmark's float64 plain reference
(``portbench/reference/fm_stereo.py``) on the cell's stereo-multiplex signal,
one block against the same block cut in two, the signal's seamless cycle and
peak deviation, the banded matmul's counters against their formulas, the
entry's spans, and the reference's imports."""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.core import registry, window
from portbench.reference import fm_stereo as ref
from yagi_tpu_torch import trace
from yagi_tpu_torch.chains import FmStereoRx
from yagi_tpu_torch.filter import FirDecimationFilter, FirFilter, FirPfbFilter

torch.set_num_threads(1)

DEV = "cpu"
C, T, BLOCKS = 4, 2048, 3  # stations, samples a block, blocks a stream
CFG = {**registry.data("configs", "fmstereo512"), "channels": C}
WL = {**registry.data("workloads", "fmstereo512.blk16k"), "block": T}  # an 8-block cycle
SEED = 2**31 + 2026
VIEW = registry.module("drivers", "fm_stereo").Driver.view
SIGNAL = registry.module("signals", "fmstereo")
CHILDREN = ("yagi.fmrx.demod", "yagi.fmrx.pilot", "yagi.fmrx.fir", "yagi.fmrx.deemph",
            "yagi.fmrx.state")
# a block cut in two equals it whole within this share of the output's rms: the
# banded matmul frames and the chunked scan segments the two parts otherwise
SPLIT_TOL = 1e-5
# the audio's gap to the reference at this size reads ~1e-6 of the rms; the
# cell's limit is wider for the tail of the stream's first block (the pilot's
# half-filled window passing near zero), which this seed does not reach
AUDIO_TOL = 1e-5


@pytest.fixture(autouse=True)
def clean_trace():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _create():
    return FmStereoRx.create(kf=CFG["kf"], f_pilot=CFG["f_pilot"], f_audio=CFG["f_audio"],
                             deemph_alpha=CFG["deemph_alpha"], n_taps=CFG["n_taps"],
                             batch_shape=(C,), device=DEV)


def _blocks():
    return SIGNAL.make(CFG, WL, SEED, torch.device(DEV))


def _leaves(obj, prefix=""):
    """(dotted name, tensor) of every tensor field, nested states walked."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + f.name, v


def test_entry_against_the_plain_reference():
    """Within the cell's limits (``configs/fmstereo512.json``), the audio
    within ``AUDIO_TOL``, block after block from the entry's own state, the
    first from zeros: the audio, the pilot level and every carried field."""
    blocks = _blocks()
    rx = _create()
    kept = []
    for i in range(BLOCKS):
        left, right, level, new = rx.step(blocks[i])
        kept.append(window.Kept(i, VIEW(rx), (left, right, level), VIEW(new)))
        rx = new
    per_block, info = ref.check(CFG, WL, blocks, kept[0], kept[1:], torch.device(DEV))
    assert info["compared_blocks"] == BLOCKS
    for b in per_block:
        assert set(b) == set(CFG["limits"])
        for name, limit in CFG["limits"].items():
            assert b[name] <= limit, (name, b[name])
        assert max(b["left_gap"], b["right_gap"]) <= AUDIO_TOL, b
    assert left.abs().square().mean().sqrt().item() > 0.1  # the audio is there


def test_the_view_holds_every_field_a_step_changes():
    rx = _create()
    new = rx.step(_blocks()[0])[3]
    changed = {n for (n, a), (_, b) in zip(_leaves(rx), _leaves(new))
               if a.shape != b.shape or not torch.equal(a, b)}
    carried = {"demod.r_prime", "pilot_bp.window", "align.window", "mono_lp.window",
               "diff_lp.window", "deemph_l.v", "deemph_r.v"}
    assert changed == carried
    view = VIEW(new)
    named = {n: t for n, t in _leaves(new)}
    assert len(view) == len(carried)
    assert all(any(t is named[n] for n in carried) for t in view.values())


def test_a_block_cut_in_two_equals_it_whole():
    x = _blocks()[1]
    rx = _create().step(_blocks()[0])[3]
    whole = rx.step(x)
    a = rx.step(x[:, :1000])
    b = a[3].step(x[:, 1000:])
    for i in (0, 1):
        got = torch.cat([a[i], b[i]], dim=-1)
        rms = whole[i].square().mean().sqrt()
        assert ((got - whole[i]).abs().max() / rms).item() < SPLIT_TOL
    for (name, w), (_, g) in zip(_leaves(whole[3]), _leaves(b[3])):
        scale = max(w.abs().max().item(), 1e-30)
        assert ((g - w).abs().max() / scale).item() < SPLIT_TOL, name
    assert torch.equal(b[3].demod.r_prime, x[:, -1])


def test_the_signal_wraps_its_cycle_with_no_seam_at_75_khz_deviation():
    """The carrier's phase after the cycle is where it started (m sums to
    zero over the cycle), each station's peak deviation is 75 kHz of its
    200 kHz channel, the pilot sits at the whole cycle count nearest 19 kHz,
    and the noise is 30 dB below the carrier."""
    prm = SIGNAL.params(CFG, WL, SEED)
    n = WL["cycle_blocks"] * T
    assert prm["pilot_cycles"] == round(0.095 * n)
    ph = torch.cat(list(SIGNAL.phases(CFG, WL, prm, torch.device(DEV))), dim=1)
    phi0 = torch.as_tensor(prm["carrier_phase"], dtype=torch.float64)
    m = SIGNAL.scale(CFG, WL, prm, torch.device(DEV))[:, None] * SIGNAL.multiplex(
        CFG, WL, prm, 0, n, torch.device(DEV))
    peak_hz = CFG["kf"] * m.abs().amax(dim=1) * 200e3
    assert peak_hz.tolist() == pytest.approx([75e3] * C, rel=1e-12)
    step = 2 * math.pi * CFG["kf"] * m  # the phase step at each sample

    def wrapped(a):
        return torch.remainder(a + math.pi, 2 * math.pi) - math.pi

    assert wrapped(ph[:, -1] - phi0).abs().max().item() < 1e-9  # back at φ0 after the cycle
    # each phase step, the one across the seam last, is the message's
    d = wrapped(torch.diff(torch.cat([ph, ph[:, :1]], dim=1)))
    assert (d - torch.roll(step, -1, dims=1)).abs().max().item() < 1e-9
    x = SIGNAL.make(CFG, WL, SEED, torch.device(DEV)).transpose(0, 1).reshape(C, n)
    clean = torch.polar(torch.ones_like(ph), ph)
    noise = (x.to(torch.complex128) - clean).abs().square().mean().item()
    assert noise == pytest.approx(1e-3, rel=0.05)
    assert torch.equal(x, SIGNAL.make(CFG, WL, SEED, torch.device(DEV)).transpose(0, 1)
                       .reshape(C, n))


def _expect(B, L, n_out, itemsize, real_mults, cols=128):
    nb = -(-n_out // 128)
    K = -(-(L + 127) // 128) * 128
    return {"frame_bytes": B * nb * K * itemsize, "macs": real_mults * B * nb * K * cols,
            "tap_macs": real_mults * B * n_out * L * (cols // 128)}


def _fir(x_dtype, h):
    f = FirFilter.create(h, batch_shape=(3,), dtype=x_dtype, device=DEV)
    x = torch.randn(3, 500, dtype=x_dtype)
    f.execute_block(x)


CASES = {
    # real signal, real taps: one real matmul
    "real": (lambda: _fir(torch.float32, np.hanning(129).astype(np.float32)),
             [_expect(3, 129, 500, 4, 1)]),
    # complex signal, real taps: its real and imaginary halves, each a real matmul
    "complex_data": (lambda: _fir(torch.complex64, np.hanning(129).astype(np.float32)),
                     [_expect(3, 129, 500, 4, 1)] * 2),
    # complex taps: one complex matmul, 4 real multiply-adds each
    "complex_taps": (lambda: _fir(torch.complex64, np.hanning(40).astype(np.complex64) * 1j),
                     [_expect(3, 40, 500, 8, 4)]),
}


def _counters():
    c = trace.snapshot()["counters"]
    return {k[len("conv."):]: v for k, v in c.items() if k.startswith("conv.")}


@pytest.mark.parametrize("case", CASES)
def test_conv_counters_equal_their_formulas(case):
    run, calls = CASES[case]
    trace.enable(False)  # counters count either way
    run()
    want = {k: sum(c[k] for c in calls) for k in calls[0]}
    assert _counters() == want


def test_conv_counters_of_the_strided_and_branch_forms():
    """A stride-4 decimator counts its four phase matmuls, whose taps cover
    the filter's L once; a bank counts one matmul of 128·M columns."""
    h = np.hanning(33).astype(np.float32)
    dec = FirDecimationFilter.create(4, h, batch_shape=(2,), dtype=torch.float32, device=DEV)
    dec.execute_block(torch.randn(2, 4 * 300))
    c = _counters()
    E = (33 - 1) // 4
    n_out = 300
    assert c["tap_macs"] == 2 * n_out * 33
    assert c["frame_bytes"] == 4 * _expect(2, E + 1, n_out, 4, 1)["frame_bytes"]
    assert c["macs"] == 4 * _expect(2, E + 1, n_out, 4, 1)["macs"]
    trace.reset()
    pfb = FirPfbFilter.create(8, np.hanning(8 * 12).astype(np.float32), batch_shape=(2,),
                              device=DEV)
    pfb.execute_all(torch.randn(2, 300))
    c = _counters()
    want = _expect(2, 12, 300, 4, 1, cols=128 * 8)
    assert c == want


def test_the_band_index_is_made_once_a_shape():
    """The banded matmul's index is a constant of (K, L, device): made at the
    first call, the same tensors after, k[u, t] = t + L − 1 − u where valid."""
    from yagi_tpu_torch.filter import _conv

    first = _conv._band_index(256, 129, torch.device(DEV))
    again = _conv._band_index(256, 129, torch.device(DEV))
    assert first[0] is again[0] and first[1] is again[1]
    k, valid = first
    u, t = torch.meshgrid(torch.arange(256), torch.arange(128), indexing="ij")
    want = t + 128 - u
    assert torch.equal(valid, (want >= 0) & (want < 129))
    assert torch.equal(k[valid], want[valid])


def test_config2_counts_half_its_macs_as_taps():
    """At 129 taps each 128-output row of a filter runs 256 multiply-adds an
    output, so 129/256 of them are the taps'; five matmuls a step."""
    rx = _create()
    rx.step(_blocks()[0])
    c = _counters()
    assert c["tap_macs"] / c["macs"] == pytest.approx(129 / 256)
    assert c["frame_bytes"] == C * 16 * 256 * (8 + 4 + 4 + 4 + 4)


def test_spans_nest_and_create_is_timed_with_tracing_off():
    rx = _create()
    spans = trace.snapshot()["spans"]
    assert spans["yagi.fmrx.create"]["count"] == 1
    x = _blocks()[0]
    rx.step(x)
    assert "yagi.fmrx.step" not in trace.snapshot()["spans"]
    trace.enable()
    rx.step(x)
    spans = trace.snapshot()["spans"]
    step = spans["yagi.fmrx.step"]
    assert step["count"] == 1 and all(spans[n]["count"] == 1 for n in CHILDREN)
    assert step["ns"] - step["self_ns"] == sum(spans[n]["ns"] for n in CHILDREN)
    deemph, iir = spans["yagi.fmrx.deemph"], spans["yagi.kernel.iir_chunked_apply"]
    assert iir["count"] == 2 and deemph["ns"] - deemph["self_ns"] == iir["ns"]
    # the pilot's FIR and the other three: the wrapper's span inside theirs
    pilot, fir = spans["yagi.fmrx.pilot"], spans["yagi.fmrx.fir"]
    wrapper = spans["yagi.kernel.fir_block_apply"]
    assert wrapper["count"] == 4
    assert pilot["ns"] - pilot["self_ns"] + fir["ns"] - fir["self_ns"] == wrapper["ns"]
    for n in ("yagi.fmrx.demod", "yagi.fmrx.state"):
        assert spans[n]["self_ns"] == spans[n]["ns"]


@pytest.mark.parametrize("on", [False, True])
def test_step_count_counts_every_call_with_tracing_on_or_off(on):
    """``fmrx.steps`` counts the calls of ``step``, so a step's share of the
    FIRs' counters reads the same over any number of calls."""
    rx = _create()
    trace.enable(on)
    for x in _blocks()[:2]:
        _, _, _, rx = rx.step(x)
    c = trace.snapshot()["counters"]
    assert c["fmrx.steps"] == 2
    assert c["conv.frame_bytes"] / c["fmrx.steps"] == C * 16 * 256 * (8 + 4 + 4 + 4 + 4)


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    root = Path(__file__).resolve().parent.parent
    code = ("import sys, portbench.reference.fm_stereo; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'yagi_tpu', 'yagi_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "[]"
