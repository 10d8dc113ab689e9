"""yagi_tpu_torch.framing's flexframe and gmskframe against yagi_tpu's.

The same numpy-seeded buffers go through yagi_tpu's object and the port's
(on the CPU). Tolerances, and why (test_torch_framing.py's):

* bytes, CRC flags, payload properties, detection or not: exactly;
* the wire protocol's id tables: equal, in order;
* flexframe samples: within 1e-6 (yagi_tpu shapes in numpy complex64, the
  port in complex128 rounded to complex64);
* GMSK frame samples: the phase is a float32 cumulative sum over the
  frame, so within 1e-6 + 64 float32 ulps of the largest |θ|
  (test_torch_cpm_fsk.py's bound for GmskMod);
* detection stats: tau within 1e-4 samples, dphi within 1e-6 rad/sample,
  phi within 1e-5 rad, gamma and rxy within 1e-5 relative, evm_db within
  1e-3 dB (the correlation surface is a complex64 FFT in both, from two
  FFT libraries); the GMSK preamble match exactly;
* the corrected symbols of flexframe's two passes: within 1e-5.

The port's derotation references the carrier ramp at the burst
(``_sync.derotate``), yagi_tpu's at the buffer's start; flexframe unwraps
the fit's angles, so the two give the same symbols.
"""

import numpy as np
import pytest
import torch

import yagi_tpu.framing as jfr
from yagi_tpu.fec.api import FecScheme as JFec
from yagi_tpu.fec.crc import CrcScheme as JCrc
from yagi_tpu.framing import flexframe as jflex
from yagi_tpu.framing import gmskframe as jgmsk
from yagi_tpu.modem.modem import ModulationScheme as JMod
import yagi_tpu_torch.framing as tfr
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.framing import _sync
from yagi_tpu_torch.framing import flexframe as tflex
from yagi_tpu_torch.framing import gmskframe as tgmsk

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
GEN_TOL = 1e-6
SYM_TOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
_STAT_ABS = {"tau": 1e-4, "dphi": 1e-6, "phi": 1e-5, "evm_db": 1e-3}
_STAT_REL = {"gamma": 1e-5, "rxy": 1e-5}


def _stats_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k in _STAT_REL:
            assert g == pytest.approx(w, rel=_STAT_REL[k]), k
        elif k == "phi":  # a wrapped angle
            assert abs(np.angle(np.exp(1j * (g - w)))) < _STAT_ABS[k], k
        elif k in _STAT_ABS:
            assert abs(g - w) < _STAT_ABS[k], k
        else:
            assert g == w, k


def _same_result(got, want) -> None:
    """Bytes, flags and props exactly; stats within the tolerances."""
    assert (got is None) == (want is None)
    if want is None:
        return
    assert sorted(got) == sorted(want)
    for k in ("header", "payload"):
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], want[k])
    for k in ("header_valid", "payload_valid"):
        assert got[k] is want[k], k
    assert got.get("props") == want.get("props")
    _stats_close(got["stats"], want["stats"])


def _channel(tx, delay, dphi, phi, gamma, snr_db, seed):
    """tests/test_flexframe.py's channel."""
    rng = np.random.default_rng(seed)
    buf = np.concatenate([np.zeros(delay, np.complex64), tx, np.zeros(64, np.complex64)])
    n = np.arange(buf.size)
    buf = gamma * buf * np.exp(1j * (dphi * n + phi))
    nstd = 10 ** (-snr_db / 20) / np.sqrt(2)
    buf = buf + nstd * (rng.standard_normal(buf.size) + 1j * rng.standard_normal(buf.size))
    return buf.astype(np.complex64)


# ------------------------------------------------------------------ the wire protocol
def test_wire_id_tables_match():
    """The in-band id tables (the wire protocol) equal yagi_tpu's, in
    order, for flexframe, ofdmflexframe and the GMSK/FSK frames."""
    from yagi_tpu_torch.fec.api import FecScheme
    from yagi_tpu_torch.fec.crc import CrcScheme
    from yagi_tpu_torch.modem.modem import ModulationScheme

    assert tflex._MOD_IDS == jflex._MOD_IDS
    assert tflex._CRC_IDS == jflex._CRC_IDS
    assert tflex._FEC_IDS == jflex._FEC_IDS
    assert tgmsk._CRC_IDS == jgmsk._CRC_IDS and tgmsk._FEC_IDS == jgmsk._FEC_IDS
    assert [s.value for s in ModulationScheme] == [s.value for s in JMod]
    assert [s.value for s in CrcScheme] == [s.value for s in JCrc]
    assert [s.value for s in FecScheme] == [s.value for s in JFec]


@pytest.mark.parametrize("mod,crc,fec0,fec1", [
    ("qpsk", "crc32", "none", "none"), ("sqam32", "crc16", "golay2412", "rs8"),
    ("pi4dqpsk", "crc8", "hamming128", "conv27p23")])
def test_protocol_bytes_match(mod, crc, fec0, fec1):
    """The six protocol bytes equal yagi_tpu's, and read back as the same
    props."""
    proto = tflex._protocol(700, mod, crc, fec0, fec1)
    assert tflex._props(proto) == {"mod_scheme": mod, "crc": crc, "fec0": fec0, "fec1": fec1,
                                   "payload_len": 700}
    want = np.array([700 >> 8, 700 & 0xFF, jflex._MOD_IDS.index(mod), jflex._CRC_IDS.index(crc),
                     jflex._FEC_IDS.index(fec0), jflex._FEC_IDS.index(fec1)], np.uint8)
    np.testing.assert_array_equal(proto, want)
    assert tflex._props(np.array([0, 0, 0, 0, 0, 0], np.uint8)) is None
    assert tflex._props(np.array([0, 9, 250, 0, 0, 0], np.uint8)) is None


# ------------------------------------------------------------------ unwrap, median
def test_unwrap_matches_numpy():
    """_sync.unwrap equals np.unwrap, on random walks and on steps of
    exactly ±π (where numpy keeps +π for a positive step)."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        theta = np.angle(np.exp(1j * np.cumsum(rng.normal(0, 1.5, 200))))
        np.testing.assert_allclose(_sync.unwrap(torch.from_numpy(theta)).numpy(),
                                   np.unwrap(theta), rtol=0, atol=1e-12)
    edges = np.array([0.0, np.pi, 0.0, -np.pi, 0.0, np.pi, 2 * np.pi, -np.pi, np.pi, 3.0, -3.0,
                      0.5, 0.5 - np.pi, 0.5])
    np.testing.assert_array_equal(_sync.unwrap(torch.from_numpy(edges)).numpy(), np.unwrap(edges))
    for short in (np.zeros(0), np.array([2.5])):
        np.testing.assert_array_equal(_sync.unwrap(torch.from_numpy(short)).numpy(),
                                      np.unwrap(short))


def test_median_of_an_even_count_averages_the_middle_two():
    """The GMSK soft scale is numpy's median: the mean of the two middle
    values of an even count, where torch.median takes the lower."""
    rng = np.random.default_rng(8)
    v = rng.normal(size=64).astype(np.float32)
    s = np.sort(np.abs(v))
    assert s[31] != s[32]
    got = tgmsk.median(torch.from_numpy(np.abs(v)))
    assert got.dtype == torch.float32 and float(got) == np.median(np.abs(v))
    assert float(got) != float(torch.from_numpy(np.abs(v)).median())
    assert float(tgmsk.median(torch.tensor([3.0, 1.0, 2.0]))) == 2.0


# ------------------------------------------------------------------ FlexFrame
_FLEX = [("qpsk", "crc32", "none", "none", 64), ("bpsk", "crc24", "none", "rep3", 30),
         ("psk8", "crc32", "hamming74", "conv27p23", 24)]


@pytest.mark.parametrize("mod,crc,fec0,fec1,plen", _FLEX)
def test_flexframe_matches(mod, crc, fec0, fec1, plen):
    """tests/test_flexframe.py's non-slow cases (and one short conv27p23
    case): the generator within GEN_TOL of yagi_tpu's; the port's sync on
    yagi_tpu's buffer gives yagi_tpu's bytes, flags and props exactly and
    its stats within the tolerances; the frame decodes."""
    rng = np.random.default_rng(plen)
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, plen).astype(np.uint8)
    tx = jfr.FlexFrameGen(14).assemble(header, payload, mod_scheme=mod, crc=crc, fec0=fec0,
                                       fec1=fec1)
    got_tx = tfr.FlexFrameGen(14, device=DEV).assemble(header, payload, mod_scheme=mod, crc=crc,
                                                       fec0=fec0, fec1=fec1)
    assert got_tx.dtype == torch.complex64 and got_tx.shape[0] == tx.size
    np.testing.assert_allclose(got_tx.numpy(), tx, rtol=0, atol=GEN_TOL)
    rx = _channel(tx, delay=97, dphi=0.003, phi=1.1, gamma=0.8, snr_db=30, seed=plen)
    want = jfr.FlexFrameSync(14).execute(rx)
    got = tfr.FlexFrameSync(14, device=DEV).execute(torch.from_numpy(rx))
    _same_result(got, want)
    assert got["header_valid"] and got["payload_valid"]
    np.testing.assert_array_equal(got["header"], header)
    np.testing.assert_array_equal(got["payload"], payload)
    assert got["props"] == {"mod_scheme": mod, "crc": crc, "fec0": fec0, "fec1": fec1,
                            "payload_len": plen}
    assert got["stats"]["evm_db"] < -15.0


def test_flexframe_symbols_match():
    """Both passes' corrected symbols (the preamble fit, then the fit
    extended over the re-encoded header) within SYM_TOL of yagi_tpu's."""
    rng = np.random.default_rng(21)
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, 48).astype(np.uint8)
    jg, js = jfr.FlexFrameGen(14), jfr.FlexFrameSync(14)
    ts = tfr.FlexFrameSync(14, device=DEV)
    tx = jg.assemble(header, payload, mod_scheme="qam16")
    rx = _channel(tx, delay=150, dphi=-0.006, phi=2.9, gamma=1.2, snr_db=28, seed=21)
    det = js.detector.detect(rx)
    tdet = ts.detector.detect(torch.from_numpy(rx))
    hlen = js.header_pm.get_frame_len()
    want, wb = js._symbols(rx, det, 64 + hlen)
    got, gb = ts._symbols(torch.from_numpy(rx), tdet, 64 + hlen)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SYM_TOL)
    assert abs(float(gb) - wb) < 1e-7
    hdr_all, ok = js.header_pm.decode_soft(want[64: 64 + hlen].astype(np.complex64))
    assert ok
    n = 64 + hlen + 200
    jk = (64 + np.arange(hlen), js.header_pm.encode(hdr_all).astype(np.complex64))
    tk = (64 + torch.arange(hlen), ts.header_pm.encode(hdr_all))
    want, wb = js._symbols(rx, det, n, known=jk)
    got, gb = ts._symbols(torch.from_numpy(rx), tdet, n, known=tk)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SYM_TOL)
    assert abs(float(gb) - wb) < 1e-7


def test_flexframe_phase_at_pi_kept():
    """A burst whose residual phase sits at ±π (the lead and CFO of
    test_framesync64_phase_reference_repaired): flexframe unwraps its fit's
    angles, so yagi_tpu (ramp at the buffer's start) and the port (ramp at
    the burst) both decode it, with the same bytes."""
    from yagi_tpu_torch.tools.paths import impair

    rng = np.random.default_rng(0)
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, 64).astype(np.uint8)
    draw = dict(lead=274, tau=0.5, dphi=0.011, phi=-0.78, gain=1.0)
    tx = tfr.FlexFrameGen(14, device=DEV).assemble(header, payload)
    buf = impair(tx, draw, 4096, torch.Generator().manual_seed(0), snr_db=20.0)
    want = jfr.FlexFrameSync(14).execute(buf.numpy())
    got = tfr.FlexFrameSync(14, device=DEV).execute(buf)
    _same_result(got, want)
    assert got["payload_valid"] and (got["payload"] == payload).all()


def test_flexframe_no_detection_short_and_errors():
    """Noise gives None in both; a buffer that ends inside the payload
    gives the header and props with no payload, as yagi_tpu; the
    generator's bad arguments raise ConfigError."""
    rng = np.random.default_rng(0)
    noise = (0.01 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))).astype(
        np.complex64)
    assert jfr.FlexFrameSync().execute(noise) is None
    assert tfr.FlexFrameSync(device=DEV).execute(noise) is None
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, 200).astype(np.uint8)
    tx = jfr.FlexFrameGen(14).assemble(header, payload)
    rx = _channel(tx, 40, 0.0, 0.3, 1.0, 30, 3)[: 40 + tx.size // 2]
    want = jfr.FlexFrameSync(14).execute(rx)
    got = tfr.FlexFrameSync(14, device=DEV).execute(rx)
    _same_result(got, want)
    assert got["header_valid"] and got["payload"] is None and got["props"]["payload_len"] == 200
    gen = tfr.FlexFrameGen(header_len=4, device=DEV)
    for h, p, kw in ((np.zeros(3, np.uint8), np.zeros(10, np.uint8), {}),
                     (np.zeros(4, np.uint8), np.zeros(0, np.uint8), {}),
                     (np.zeros(4, np.uint8), np.zeros(8, np.uint8), {"mod_scheme": "nope"}),
                     (np.zeros(4, np.uint8), np.zeros(8, np.uint8), {"fec1": "nope"})):
        with pytest.raises(ConfigError):
            gen.assemble(h, p, **kw)
    with pytest.raises(ConfigError):
        tfr.FlexFrameGen(header_len=-1, device=DEV)


# ------------------------------------------------------------------ GmskFrame
@pytest.mark.parametrize("k,m,bt", [(2, 5, 0.2), (2, 3, 0.5), (4, 5, 0.3), (3, 7, 0.2)])
def test_gmskframe_matches(k, m, bt):
    """tests/test_flexframe.py's GMSK cases (its first (k, m, bt), and
    three more of its grid at a 25-dB channel): the generator within the
    phase tolerance of yagi_tpu's; bytes, flags, props and the preamble
    match exactly and stats within the tolerances on yagi_tpu's buffer."""
    rng = np.random.default_rng(int(k * 100 + m * 10 + bt * 10))
    header = rng.integers(0, 256, 8).astype(np.uint8)
    payload = rng.integers(0, 256, 40).astype(np.uint8)
    tx = np.asarray(jfr.GmskFrameGen(k=k, m=m, bt=bt, header_len=8).assemble(
        header, payload, crc="crc32", fec0="hamming128", fec1="none"))
    got_tx = tfr.GmskFrameGen(k=k, m=m, bt=bt, header_len=8, device=DEV).assemble(
        header, payload, crc="crc32", fec0="hamming128", fec1="none")
    theta = np.abs(np.cumsum(np.angle(tx[1:] * np.conj(tx[:-1])))).max()
    np.testing.assert_allclose(got_tx.numpy(), tx, rtol=0,
                               atol=1e-6 + 64 * EPS32 * max(1.0, theta))
    rx = _channel(tx, delay=71, dphi=0.002, phi=0.7, gamma=1.3, snr_db=25, seed=m)
    want = jfr.GmskFrameSync(k=k, m=m, bt=bt, header_len=8).execute(rx)
    got = tfr.GmskFrameSync(k=k, m=m, bt=bt, header_len=8, device=DEV).execute(rx)
    _same_result(got, want)
    assert got["payload_valid"] and (got["payload"] == payload).all()
    assert got["props"]["payload_len"] == 40


def test_gmskframe_soft_levels_match():
    """The decision-rate values and soft levels (median scale) within 1e-5
    of yagi_tpu's, computed from the same detection."""
    rng = np.random.default_rng(12)
    header = rng.integers(0, 256, 8).astype(np.uint8)
    payload = rng.integers(0, 256, 32).astype(np.uint8)
    tx = np.asarray(jfr.GmskFrameGen(k=2, m=3, bt=0.5).assemble(header, payload))
    rx = _channel(tx, delay=33, dphi=-0.004, phi=-2.0, gamma=0.7, snr_db=18, seed=12)
    ts = tfr.GmskFrameSync(k=2, m=3, bt=0.5, device=DEV)
    det = ts.detector.detect(torch.from_numpy(rx))
    bits_sig, soft = ts._soft(torch.from_numpy(rx), det)
    # yagi_tpu's steps (gmskframe.py:124-142) at the same detection
    n = np.arange(rx.size)
    y = rx * np.exp(-1j * det["dphi"] * n)
    i0 = int(np.floor(det["tau"]))
    frac = det["tau"] - i0
    f = np.fft.fftfreq(y.size)
    y = np.fft.ifft(np.fft.fft(y) * np.exp(2j * np.pi * f * frac))[i0:].astype(np.complex64)
    fr = np.angle(y * np.conj(np.concatenate([[1.0 + 0j], y[:-1]]))).astype(np.float32)
    rx_h = np.asarray(jfr.GmskFrameSync(k=2, m=3, bt=0.5)._rx_h)
    d = np.convolve(fr, rx_h)[: fr.size][::2][6:]
    scale = np.median(np.abs(d[:64])) + 1e-12
    np.testing.assert_allclose(bits_sig.numpy(), d, rtol=0, atol=1e-5)
    np.testing.assert_allclose(soft.numpy(), np.clip(0.5 + 0.5 * d / (2.0 * scale), 0, 1),
                               rtol=0, atol=1e-5)


def test_gmskframe_no_detection_and_errors():
    rng = np.random.default_rng(1)
    noise = (0.01 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))).astype(
        np.complex64)
    assert jfr.GmskFrameSync(k=2, m=4, bt=0.3).execute(noise) is None
    assert tfr.GmskFrameSync(k=2, m=4, bt=0.3, device=DEV).execute(noise) is None
    with pytest.raises(ConfigError):
        tfr.GmskFrameGen(k=1, device=DEV)
    with pytest.raises(ConfigError):
        tfr.GmskFrameGen(bt=1.5, device=DEV)
    gen = tfr.GmskFrameGen(device=DEV)
    with pytest.raises(ConfigError):
        gen.assemble(np.zeros(7, np.uint8), np.zeros(10, np.uint8))
    with pytest.raises(ConfigError):
        gen.assemble(np.zeros(8, np.uint8), np.zeros(4, np.uint8), crc="bogus")


def test_default_device_is_the_card():
    """With no device the frame objects build on the card, and raise
    DeviceError where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (tfr.FlexFrameGen, tfr.FlexFrameSync, tfr.GmskFrameGen, tfr.GmskFrameSync):
        with pytest.raises(DeviceError):
            make()
