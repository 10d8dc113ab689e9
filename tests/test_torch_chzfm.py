"""ChannelizerFmRx (config[4]: K2 → FM discriminator over 64 channels) on
the CPU route: against the benchmark's float64 reference of liquid's
analyzer and freqdem, block invariance, its discriminator against Freqdem,
the wrapper's FM route against the entry's earlier two calls, and its spans
and counter."""

import re
from pathlib import Path

import pytest
import torch

from portbench.core import registry
from portbench.reference import chz_fm
from yagi_tpu_torch import trace
from yagi_tpu_torch.chains import ChannelizerFmRx
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.modem import Freqdem

torch.set_num_threads(1)

DEV = "cpu"
T, BLOCKS = 512, 3  # analyzer steps a block (N = 64·T, a multiple of 16,384), blocks a stream
CFG = registry.data("configs", "chz64fm")
SPANS = ("yagi.chzfm.channelize", "yagi.chzfm.demod", "yagi.chzfm.state")
KERNEL = "yagi.kernel.fused_channelizer_apply"


def _fmband(seed):
    wl = {"block": T, "cycle_blocks": BLOCKS}
    return list(registry.module("signals", "fmband").make(CFG, wl, seed, torch.device(DEV)))


def _noise(seed):
    g = torch.Generator().manual_seed(seed)
    return list(torch.randn((BLOCKS, 2, 64 * T), generator=g))


def _stream(rx, blocks):
    outs = []
    for x in blocks:
        yr, yi, fm, rx = rx.step(x[0], x[1])
        outs.append((yr, yi, fm))
    return outs, rx


def _state(rx):
    return {"hist_r": rx.chz.hist_r, "hist_i": rx.chz.hist_i, "r_prime": rx.r_prime}


@pytest.fixture(autouse=True)
def clean_trace():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.mark.parametrize("signal", [_fmband, _noise], ids=["fmband", "noise"])
def test_entry_against_the_float64_reference(signal):
    """Within the cell's limits (``configs/chz64fm.json``), block after block
    from the entry's own state: the channels and the last outputs within 1e-4
    of the channels' rms (float32 sums of 8 taps and a 64-point transform
    read ~1e-6), the discriminator within 1e-3 of its rms as an angle (its
    largest gaps sit in the stream's first steps, where the prototype's edge
    taps leave the channels at ~1e-4 of their rms), the history an exact
    copy."""
    limits = CFG["limits"]
    h = chz_fm.prototype(CFG)
    rx = ChannelizerFmRx.create(device=DEV)
    for x in signal(7):
        before = _state(rx)
        yr, yi, fm, rx = rx.step(x[0], x[1])
        y_ref = chz_fm.analyzer(x[0], x[1], before["hist_r"], before["hist_i"], h, 64)
        fm_ref = chz_fm.discriminate(y_ref, before["r_prime"], CFG["kf"])
        rms = y_ref.abs().square().mean().sqrt()
        assert (torch.complex(yr, yi) - y_ref).abs().max() / rms <= limits["chan_gap"]
        assert chz_fm._fm_gap(fm, fm_ref, CFG["kf"]) <= limits["fm_gap"]
        assert (rx.r_prime - y_ref[-1]).abs().max() / rms <= limits["state_gap"]
        nh = rx.chz.hist_r.shape[0]
        assert torch.equal(rx.chz.hist_r, x[0][-nh:]) and torch.equal(rx.chz.hist_i, x[1][-nh:])


def test_three_blocks_equal_one_long_call():
    """Bit for bit: the CPU route computes each 128-sample row's branch sums
    and transform alone, in one order, however long the block."""
    blocks = _fmband(11)
    outs, rx3 = _stream(ChannelizerFmRx.create(device=DEV), blocks)
    whole = torch.cat(blocks, dim=1)
    yr, yi, fm, rx1 = ChannelizerFmRx.create(device=DEV).step(whole[0], whole[1])
    for got, want in zip((yr, yi, fm), zip(*outs)):
        assert torch.equal(got, torch.cat(want))
    for key, value in _state(rx1).items():
        assert torch.equal(value, _state(rx3)[key])


@pytest.mark.parametrize("signal", [_fmband, _noise], ids=["fmband", "noise"])
def test_discriminator_against_freqdem(signal):
    """Within 2 float32 ulps of fm (|fm| ≤ π/(2π·kf) = 5, an ulp 4.8e-7):
    one rounding of each product apart, Freqdem multiplying complex values
    and the entry its planes with fused multiply-adds; the last samples
    carried equal."""
    rx = ChannelizerFmRx.create(device=DEV)
    fd = Freqdem.create(CFG["kf"], batch_shape=(64,), device=DEV)
    for x in signal(5):
        yr, yi, fm, rx = rx.step(x[0], x[1])
        want, fd = fd.demodulate(torch.complex(yr, yi).T)
        assert (fm - want.T).abs().max() <= 1e-6
        assert torch.equal(rx.r_prime, fd.r_prime)


def test_outputs_are_k2s_planes_and_the_state_copies():
    rx = ChannelizerFmRx.create(device=DEV)
    x = _noise(3)[0]
    yr, yi, fm, new = rx.step(x[0], x[1])
    assert yr.shape == yi.shape == fm.shape == (T, 64) and yr.is_contiguous()
    assert fm.dtype == torch.float32 and new.r_prime.dtype == torch.complex64
    assert torch.equal(new.r_prime, torch.complex(yr[-1], yi[-1]))
    assert new.r_prime.data_ptr() not in (yr.data_ptr(), yi.data_ptr())
    assert new.chz.hist_r.data_ptr() != x[0].data_ptr()
    assert torch.equal(rx.r_prime, torch.zeros(64, dtype=torch.complex64))  # the old state stands
    assert new.ref == pytest.approx(1.0 / (2.0 * torch.pi * CFG["kf"]), rel=1e-7)


@pytest.mark.parametrize("kw", [{"kf": 0.0}, {"kf": -0.1}, {"num_channels": 32}])
def test_bad_parameters_raise(kw):
    with pytest.raises(ConfigError):
        ChannelizerFmRx.create(device=DEV, **kw)


def _two_calls(rx, xr, xi):
    """The entry's step as two calls, the channelizer and then the
    discriminator's torch ops on its planes, with row 0 against the carried
    last outputs: the form it had before its one call of the wrapper's FM
    route."""
    yr, yi, chz = rx.chz.analyzer_execute_planar(xr, xi)
    fm = torch.empty_like(yr)
    rp = rx.r_prime
    for pr, pi, rr, ri, out in ((rp.real, rp.imag, yr[0], yi[0], fm[0]),
                                (yr[:-1], yi[:-1], yr[1:], yi[1:], fm[1:])):
        im = pr * ri
        im.addcmul_(pi, rr, value=-1.0)
        re = pr * rr
        re.addcmul_(pi, ri)
        torch.atan2(im, re, out=out)
    fm.mul_(rx.ref)
    return yr, yi, fm, rx.replace(chz=chz, r_prime=torch.complex(yr[-1], yi[-1]))


@pytest.mark.parametrize("m", [4, 33], ids=["p8", "p66"])
@pytest.mark.parametrize("signal", [_fmband, _noise], ids=["fmband", "noise"])
def test_fm_route_equals_the_two_calls(signal, m):
    """Bit for bit, block after block: the CPU route of
    ``fused_channelizer_apply(..., fm=...)`` is the channelizer's reference and
    then the same torch ops; at 66 taps a branch (the card's tiled instance,
    which has no epilogue) too."""
    one = two = ChannelizerFmRx.create(m=m, device=DEV)
    for x in signal(13):
        *got, one = one.step(x[0], x[1])
        *want, two = _two_calls(two, x[0], x[1])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(v, _state(two)[k]) for k, v in _state(one).items())


def test_fm_instance_limit_mirrors_the_kernel_source():
    """The wrapper hands p ≤ ``_MAX_ONE_PASS`` taps a branch to K2's FM
    instance, which ``csrc/channelizer.cu`` runs up to kMaxOnePass = kRing −
    2·kTile and refuses past."""
    from yagi_tpu_torch.kernels import channelizer

    src = (Path(channelizer.__file__).parent.parent / "csrc" / "channelizer.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    tile = const["kThreads"] // const["kGroup"]
    assert channelizer._MAX_ONE_PASS == const["kRing"] - 2 * tile
    assert "constexpr int kMaxOnePass = kRing - 2 * kTile;" in src
    assert "if (p > kMaxOnePass) return (int)cudaErrorInvalidValue;" in src


def test_spans_and_counter():
    """The CPU route is the two-step one: step ⊃ channelize ⊃ the kernel
    wrapper ⊃ demod, and step ⊃ state; no launch, no FM-instance count."""
    from yagi_tpu_torch.kernels.channelizer import fused_channelizer_apply

    rx = ChannelizerFmRx.create(device=DEV)
    assert trace.snapshot()["spans"]["yagi.chzfm.create"]["count"] == 1  # timed with tracing off
    trace.reset()
    launches = fused_channelizer_apply.launches
    trace.enable()
    for x in _noise(2)[:2]:
        _, _, _, rx = rx.step(x[0], x[1])
    snap = trace.snapshot()
    spans = snap["spans"]
    step = spans["yagi.chzfm.step"]
    assert step["count"] == 2 and all(spans[s]["count"] == 2 for s in SPANS)
    channelize, demod, state = (spans[s] for s in SPANS)
    assert step["self_ns"] == step["ns"] - channelize["ns"] - state["ns"]
    kernel = spans[KERNEL]
    assert kernel["count"] == 2
    assert channelize["self_ns"] == channelize["ns"] - kernel["ns"]
    assert kernel["self_ns"] == kernel["ns"] - demod["ns"]
    assert not [n for n in spans if n.endswith(".launch")]  # the CPU route launches nothing
    assert fused_channelizer_apply.launches == launches
    assert "channelizer.fm_epilogue" not in snap["counters"]


def test_outputs_and_state_are_the_same_with_tracing_on_and_off():
    blocks = _noise(4)
    results = []
    for on in (False, True):
        trace.enable(on)
        results.append(_stream(ChannelizerFmRx.create(device=DEV), blocks))
    (outs0, rx0), (outs1, rx1) = results
    assert all(torch.equal(a, b) for o0, o1 in zip(outs0, outs1) for a, b in zip(o0, o1))
    assert all(torch.equal(v, _state(rx1)[k]) for k, v in _state(rx0).items())
