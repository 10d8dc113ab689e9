"""yagi_tpu_torch.framing's packet layer against yagi_tpu.framing.

The same numpy-seeded buffers go through yagi_tpu's object and the port's
(on the CPU). Tolerances, and why:

* bytes, CRC flags, symbol decisions, detection or not: exactly;
* modulated packets (a table gather): exactly;
* frame64 samples: within 1e-6 (yagi_tpu shapes in numpy complex64, the
  port in complex128 rounded to complex64; 1.8e-7 measured);
* detection stats: the correlation surface is a complex64 FFT in both,
  from two FFT libraries, so the peak's neighbours differ by float32
  rounding (~1e-7 relative): tau within 1e-4 samples, dphi within 1e-6
  rad/sample, phi within 1e-5 rad, gamma and rxy within 1e-5 relative,
  evm_db within 1e-3 dB (1.2e-7, 1.4e-9, 3e-8, 1.2e-7 relative and 3.3e-6
  dB measured on the frame64 channels);
* synchronized symbols (QDSync, QPilotSync): within 1e-5 of unit-power
  symbols (those stats' differences carried through the corrections);
* SymStream/SymStreamR samples: within 1e-5 (float32 filters in two
  summation orders).

One case departs from yagi_tpu on purpose: the synchronizers reference the
carrier ramp at the burst (test_framesync64_phase_reference_repaired), where
yagi_tpu loses a frame whose residual phase sits at ±π.
"""

import copy

import numpy as np
import pytest
import torch

import yagi_tpu.framing as jfr
from yagi_tpu.errors import ConfigError as JConfigError
from yagi_tpu.modem import Modem as JModem
from yagi_tpu_torch._src.struct import load_into
from yagi_tpu_torch.errors import ConfigError, DeviceError
import yagi_tpu_torch.framing as tfr
from yagi_tpu_torch.framing import _carrier as tcarrier
from yagi_tpu.framing import _carrier as jcarrier
from yagi_tpu_torch.modem import Modem

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
SYM_TOL = 1e-5
GEN_TOL = 1e-6
STREAM_TOL = 1e-5
_STAT_ABS = {"tau": 1e-4, "dphi": 1e-6, "phi": 1e-5, "evm_db": 1e-3}
_STAT_REL = {"gamma": 1e-5, "rxy": 1e-5}
_SCHEMES = ["bpsk", "qpsk", "psk8", "qam16", "sqam32", "qam64", "sqam128", "qam256"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _stats_close(got: dict, want: dict) -> None:
    for k, w in want.items():
        g = got[k]
        if k in _STAT_REL:
            assert g == pytest.approx(w, rel=_STAT_REL[k]), k
        elif k == "phi":  # a wrapped angle
            assert abs(np.angle(np.exp(1j * (g - w)))) < _STAT_ABS[k], k
        elif k in _STAT_ABS:
            assert abs(g - w) < _STAT_ABS[k], k
        else:
            assert g == pytest.approx(w, rel=1e-5, abs=1e-6), k


def _noise(rng, n, scale):
    return (scale * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)


# ------------------------------------------------------------------ QPacketModem
@pytest.mark.parametrize("ms", _SCHEMES)
def test_qpacketmodem_roundtrip_matches(ms):
    """test_framing2.py:21-35 on the port: the packet's samples equal
    yagi_tpu's exactly, and hard and soft decoding give the payload and a
    valid CRC, as yagi_tpu's do (with noise, the same payload and flag)."""
    rng = np.random.default_rng(1)
    jq = jfr.QPacketModem(40, crc="crc32", fec0="hamming128", fec1="conv27p23", mod_scheme=ms)
    tq = tfr.QPacketModem(40, crc="crc32", fec0="hamming128", fec1="conv27p23", mod_scheme=ms,
                          device=DEV)
    payload = rng.integers(0, 256, 40).astype(np.uint8)
    x = tq.encode(payload)
    assert x.dtype == torch.complex64 and tq.get_frame_len() == jq.get_frame_len() == x.shape[0]
    np.testing.assert_array_equal(_np(x), jq.encode(payload))
    np.testing.assert_array_equal(tq.encode_syms(payload), jq.encode_syms(payload))
    for decode in ("decode", "decode_soft"):
        dec, ok = getattr(tq, decode)(x)
        assert ok and (dec == payload).all()
    noisy = (_np(x) + _noise(rng, x.shape[0], 0.12)).astype(np.complex64)
    for decode in ("decode", "decode_soft"):
        (jd, jok), (td, tok) = getattr(jq, decode)(noisy), getattr(tq, decode)(noisy)
        np.testing.assert_array_equal(td, jd)
        assert tok is jok


def test_qpacketmodem_soft_under_noise():
    """test_framing2.py's soft decode under noise, and the uncoded (crc
    none) packet; a wrong length raises."""
    rng = np.random.default_rng(2)
    q = tfr.QPacketModem(64, crc="crc32", fec0="hamming128", fec1="conv27p23", device=DEV)
    payload = rng.integers(0, 256, 64).astype(np.uint8)
    x = _np(q.encode(payload))
    noisy = (x + 0.1 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
             ).astype(np.complex64)
    dec, ok = q.decode_soft(noisy)
    assert ok and (dec == payload).all()
    u = tfr.QPacketModem(48, crc="none", fec0="none", fec1="none", mod_scheme="qam16",
                         device=DEV)
    p48 = rng.integers(0, 256, 48).astype(np.uint8)
    dec, ok = u.decode(u.encode(p48))
    assert ok and (dec == p48).all()
    with pytest.raises(ConfigError):
        tfr.QPacketModem(16, device=DEV).decode(np.zeros(3, np.complex64))


# ------------------------------------------------------------------ QDetector
def _qdet_case(rng, s, tau, dphi, phi, gamma, n, noise):
    x = _noise(rng, n, noise)
    k = np.arange(s.size)
    x[tau: tau + s.size] += (gamma * s * np.exp(1j * (dphi * k + phi))).astype(np.complex64)
    return x


@pytest.mark.parametrize("n,seed", [(96, 3), (64, 65), (167, 168), (1024, 1025)])
def test_qdetector_stats_match(n, seed):
    """test_framing2.py's estimation case (n 96) and the linear reference
    scenarios: detected in both, stats within the module's tolerances."""
    rng = np.random.default_rng(seed)
    if n == 96:
        s = (rng.normal(size=96) + 1j * rng.normal(size=96)).astype(np.complex64)
        x = _qdet_case(rng, s, 201, 0.008, -1.2, 0.7, 600, 0.05)
    else:
        s = (((1 - 2 * rng.integers(0, 2, n)) + 1j * (1 - 2 * rng.integers(0, 2, n)))
             / np.sqrt(2)).astype(np.complex64)
        x = _qdet_case(rng, s, 3 * n // 4, 0.005, -0.7, 0.8, 3 * n, 0.02)
    want = jfr.QDetector(s, threshold=0.5, dphi_max=0.02, n_dphi=9).detect(x)
    got = tfr.QDetector(s, threshold=0.5, dphi_max=0.02, n_dphi=9, device=DEV).detect(
        torch.from_numpy(x))
    assert want is not None and got is not None
    _stats_close(got, want)


def test_qdetector_noise_and_copy():
    """No detection on noise in either; a deep copy detects identically."""
    rng = np.random.default_rng(4)
    s = (rng.normal(size=96) + 1j * rng.normal(size=96)).astype(np.complex64)
    jd, td = jfr.QDetector(s, threshold=0.5), tfr.QDetector(s, threshold=0.5, device=DEV)
    for _ in range(3):
        x = _noise(rng, 600, 1.0)
        assert jd.detect(x) is None and td.detect(x) is None
    x = _noise(rng, 500, 0.05)
    x[140:236] += s
    r0, r1 = td.detect(x), copy.deepcopy(td).detect(x)
    assert r0 == r1


# ------------------------------------------------------------------ QDSync
def _qdsync_buf(rng, sync_h, k, pre, payload, delay, phi, dphi, snr_db):
    allsyms = np.concatenate([pre, payload, np.zeros(16, np.complex64)])
    up = np.zeros(allsyms.size * k, dtype=np.complex64)
    up[::k] = allsyms
    tx = np.convolve(up, sync_h)
    tx = tx * np.exp(1j * (dphi * np.arange(tx.size) + phi))
    buf = np.concatenate([np.zeros(delay, np.complex64), tx, np.zeros(50, np.complex64)])
    if snr_db is not None:
        nstd = 10 ** (-snr_db / 20) / np.sqrt(2)
        buf = buf + nstd * (rng.standard_normal(buf.size) + 1j * rng.standard_normal(buf.size))
    return buf.astype(np.complex64)


def _qpsk_payload(n, seed):
    syms = np.random.default_rng(seed).integers(0, 4, n)
    x, _ = JModem.create("qpsk").modulate(syms.astype(np.uint32))
    return np.asarray(x), syms


@pytest.mark.parametrize("k,dphi,snr", [(2, 0.0, 35.0), (3, 0.0, 35.0), (4, 0.0, 35.0),
                                        (2, 0.01, None)])
def test_qdsync_matches(k, dphi, snr):
    """test_qframing.py's QDSync cases (k 2, 3, 4 at 35 dB, and a carrier
    offset of 0.01): symbols within SYM_TOL and stats within the module's
    tolerances of yagi_tpu's; the payload decides error-free."""
    rng = np.random.default_rng(k)
    pre = (1.0 - 2.0 * rng.integers(0, 2, 64)).astype(np.complex64)
    payload, syms = _qpsk_payload(240, seed=k)
    js = jfr.QDSync(pre, k=k, m=7, beta=0.3)
    ts = tfr.QDSync(pre, k=k, m=7, beta=0.3, device=DEV)
    np.testing.assert_array_equal(ts._h, js._h)
    buf = _qdsync_buf(rng, js._h, k, pre, payload, 113, 1.2, dphi, snr)
    want, got = js.execute(buf), ts.execute(torch.from_numpy(buf))
    assert want is not None and got is not None
    assert got[0].dtype == torch.complex64 and got[0].shape[0] == want[0].shape[0]
    np.testing.assert_allclose(_np(got[0]), want[0], rtol=0, atol=SYM_TOL)
    _stats_close(got[1], want[1])
    dsyms, _ = Modem.create("qpsk", device=DEV).demodulate(got[0][64: 64 + 240])
    np.testing.assert_array_equal(_np(dsyms), syms)


def test_qdsync_buf_len_and_no_detection():
    """set_buf_len caps the symbols (n_symbols overrides it), as in
    yagi_tpu; noise gives None in both."""
    rng = np.random.default_rng(12)
    pre = (1.0 - 2.0 * rng.integers(0, 2, 64)).astype(np.complex64)
    payload, _ = _qpsk_payload(120, seed=13)
    js, ts = jfr.QDSync(pre), tfr.QDSync(pre, device=DEV)
    for s in (js, ts):
        s.set_buf_len(100)
        assert s.get_buf_len() == 100
    buf = _qdsync_buf(rng, js._h, 2, pre, payload, 37, 0.0, 0.0, None)
    (jo, _), (to, _) = js.execute(buf), ts.execute(buf)
    assert to.shape[0] == 100
    np.testing.assert_allclose(_np(to), jo, rtol=0, atol=SYM_TOL)
    to80, _ = ts.execute(buf, n_symbols=80)
    np.testing.assert_array_equal(_np(to80), _np(to)[:80])
    noise = (0.01 * (rng.standard_normal(2048) + 1j * rng.standard_normal(2048))
             ).astype(np.complex64)
    assert js.execute(noise) is None and ts.execute(noise) is None


# ------------------------------------------------------------------ QPilot
@pytest.mark.parametrize("payload_len,spacing,noise", [
    (100, 16, False), (200, 20, False), (300, 24, False), (400, 28, False), (500, 32, False),
    (200, 20, True)])
def test_qpilot_matches(payload_len, spacing, noise):
    """test_qframing.py's QPilot cases: the frame equals yagi_tpu's exactly,
    the corrected payload is within SYM_TOL and the info within 1e-5
    (dphi 1e-7) of yagi_tpu's, and it decides error-free."""
    jg, tg = jfr.QPilotGen(payload_len, spacing), tfr.QPilotGen(payload_len, spacing, device=DEV)
    js, ts = jfr.QPilotSync(payload_len, spacing), tfr.QPilotSync(payload_len, spacing,
                                                                  device=DEV)
    assert tg.get_frame_len() == jg.get_frame_len() == ts.get_frame_len()
    payload, syms = _qpsk_payload(payload_len, seed=3 if noise else payload_len)
    frame = jg.execute(payload)
    np.testing.assert_array_equal(_np(tg.execute(payload)), frame)
    n = np.arange(frame.size)
    if noise:
        rng = np.random.default_rng(17)
        rx = 1.2 * frame * np.exp(1j * (-0.002 * n + 0.5))
        rx = rx + 10 ** (-30 / 20) / np.sqrt(2) * (rng.standard_normal(rx.size)
                                                   + 1j * rng.standard_normal(rx.size))
    else:
        rx = 0.7 * frame * np.exp(1j * (0.001 * n + 2.1))
    rx = rx.astype(np.complex64)
    (jo, jinfo), (to, tinfo) = js.execute(rx), ts.execute(torch.from_numpy(rx))
    np.testing.assert_allclose(_np(to), jo, rtol=0, atol=SYM_TOL)
    assert abs(tinfo["dphi"] - jinfo["dphi"]) < 1e-7
    for key in ("phi", "gain", "evm"):
        assert abs(tinfo[key] - jinfo[key]) < 1e-5, key
    dsyms, _ = Modem.create("qpsk", device=DEV).demodulate(to)
    np.testing.assert_array_equal(_np(dsyms), syms)


# ------------------------------------------------------------------ frame64
def _frame_channel(seed, snr_db, dphi, tau_frac, gain):
    """test_framing2.py:112-135's impaired buffer."""
    rng = np.random.default_rng(seed)
    hdr = rng.integers(0, 256, 8).astype(np.uint8)
    pld = rng.integers(0, 256, 64).astype(np.uint8)
    frame = jfr.FrameGen64().execute(hdr, pld)
    i0 = 81
    f = np.fft.fftfreq(frame.size)
    frame_d = np.fft.ifft(np.fft.fft(frame) * np.exp(-2j * np.pi * f * tau_frac))
    buf = np.zeros(frame.size + 260, np.complex64)
    n = np.arange(frame.size)
    buf[i0: i0 + frame.size] = (gain * frame_d * np.exp(1j * (dphi * (n + i0) + 0.4))
                                ).astype(np.complex64)
    sigma = gain * np.sqrt(np.mean(np.abs(frame) ** 2)) * 10 ** (-snr_db / 20) / np.sqrt(2)
    buf += (rng.normal(0, sigma, buf.size) + 1j * rng.normal(0, sigma, buf.size)
            ).astype(np.complex64)
    return buf, hdr, pld


def test_framegen64_matches():
    """FrameGen64's samples within GEN_TOL of yagi_tpu's; FRAME64_LEN and
    the bad lengths as yagi_tpu."""
    rng = np.random.default_rng(5)
    hdr = rng.integers(0, 256, 8).astype(np.uint8)
    pld = rng.integers(0, 256, 64).astype(np.uint8)
    got = tfr.FrameGen64(device=DEV).execute(hdr, pld)
    assert got.dtype == torch.complex64 and got.shape[0] == tfr.FRAME64_LEN == jfr.FRAME64_LEN
    np.testing.assert_allclose(_np(got), jfr.FrameGen64().execute(hdr, pld), rtol=0,
                               atol=GEN_TOL)
    gen = tfr.FrameGen64(device=DEV)
    for h, p in ((np.zeros(7, np.uint8), pld), (hdr, np.zeros(63, np.uint8))):
        with pytest.raises(ConfigError):
            gen.execute(h, p)


@pytest.mark.parametrize("seed,dphi,tau_frac,gain", [
    (10, 0.012, 0.37, 0.5), (11, -0.008, 0.81, 1.3), (12, 0.0, 0.0, 1.0)])
def test_framesync64_impaired_matches(seed, dphi, tau_frac, gain):
    """test_framing2.py:149-160's three impaired channels at 20 dB: the
    header, payload and CRC flags identical to yagi_tpu's, the stats within
    the module's tolerances, and the frame recovered with |dphi error| <
    1e-3 (that test's bound)."""
    buf, hdr, pld = _frame_channel(seed, 20.0, dphi, tau_frac, gain)
    want = jfr.FrameSync64().execute(buf)
    got = tfr.FrameSync64(device=DEV).execute(torch.from_numpy(buf))
    assert want is not None and got is not None
    for k in ("header", "payload"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[f"{k}_valid"] is want[f"{k}_valid"] is True
    np.testing.assert_array_equal(got["header"], hdr)
    np.testing.assert_array_equal(got["payload"], pld)
    _stats_close(got["stats"], want["stats"])
    assert abs(got["stats"]["dphi"] - dphi) < 1e-3


def test_framesync64_phase_reference_repaired():
    """Shared fault, repaired in the port (ROADMAP queue 3): yagi_tpu
    derotates by e^{−j(dphi·n + phi)} from the buffer's start while phi is
    the carrier's phase at the burst (the correlation peak), which leaves a
    constant phase of about −dphi·tau on the symbols. At a lead of 274 with
    dphi 0.011 it sits near ±π, the preamble's angles wrap, the phase fit
    fails and yagi_tpu loses the payload; the port references the ramp at
    tau and decodes it. The buffer: tools/paths.py's impairments (20 dB),
    torch noise seed 0."""
    from yagi_tpu_torch.tools.paths import impair

    rng = np.random.default_rng(0)
    hdr = rng.integers(0, 256, 8).astype(np.uint8)
    pld = rng.integers(0, 256, 64).astype(np.uint8)
    draw = dict(lead=274, tau=0.5, dphi=0.011, phi=-0.78, gain=1.0)
    buf = impair(tfr.FrameGen64(device=DEV).execute(hdr, pld), draw, 4096,
                 torch.Generator().manual_seed(0))
    want = jfr.FrameSync64().execute(_np(buf))
    assert want is not None and not (want["header_valid"] and want["payload_valid"])
    got = tfr.FrameSync64(device=DEV).execute(buf)
    assert got["header_valid"] and got["payload_valid"]
    np.testing.assert_array_equal(got["header"], hdr)
    np.testing.assert_array_equal(got["payload"], pld)
    assert abs(got["stats"]["dphi"] - draw["dphi"]) < 1e-3 and got["stats"]["evm_db"] < -15


def test_framesync64_clean_noise_and_export(tmp_path):
    """A clean frame decodes (EVM < −35 dB); noise gives None; the debug
    export in its three situations, as test_framing2.py."""
    rng = np.random.default_rng(29)
    hdr = rng.integers(0, 256, 8).astype(np.uint8)
    pld = rng.integers(0, 256, 64).astype(np.uint8)
    frame = tfr.FrameGen64(device=DEV).execute(hdr, pld)
    sync = tfr.FrameSync64(device=DEV)
    with pytest.raises(ConfigError):
        sync.debug_export(str(tmp_path / "early.m"))
    n = tfr.FRAME64_LEN
    buf = torch.zeros(n + 80, dtype=torch.complex64)
    buf[40: 40 + n] = frame
    r = sync.execute(buf)
    assert r["header_valid"] and r["payload_valid"] and r["stats"]["evm_db"] < -35
    assert (r["header"] == hdr).all() and (r["payload"] == pld).all()
    sync.debug_export(str(tmp_path / "user.m"))
    text = (tmp_path / "user.m").read_text()
    assert "frame_detected = 1;" in text and "syms = [" in text
    noise = _noise(rng, n + 200, 1.0)
    assert sync.execute(noise) is None and jfr.FrameSync64().execute(noise) is None
    sync.debug_export(str(tmp_path / "ndet.m"))
    assert "frame_detected = 0;" in (tmp_path / "ndet.m").read_text()
    bad = buf.clone()
    bad[40 + 700: 40 + 900] = 0
    sync.execute(bad)
    sync.debug_export(str(tmp_path / "head.m"))
    assert "num_samples = %d;" % bad.shape[0] in (tmp_path / "head.m").read_text()


# ------------------------------------------------------------------ SymStream
@pytest.mark.parametrize("k,scheme", [(2, "qpsk"), (4, "qam16")])
def test_symstream_matches(k, scheme):
    """SymStream's samples within STREAM_TOL of yagi_tpu's over blocks of
    333 and 167, with set_gain between them."""
    from yagi_tpu.design import FirFilterShape as JShape
    from yagi_tpu_torch.design import FirFilterShape

    jg = jfr.SymStream(JShape.ARKAISER, k, 7, 0.3, scheme)
    tg = tfr.SymStream(FirFilterShape.ARKAISER, k, 7, 0.3, scheme, device=DEV)
    assert tg.get_delay() == jg.get_delay()
    a = _np(tg.write_samples(333))
    np.testing.assert_allclose(a, jg.write_samples(333), rtol=0, atol=STREAM_TOL)
    for g in (jg, tg):
        g.set_gain(0.5)
    b = _np(tg.write_samples(167))
    np.testing.assert_allclose(b, jg.write_samples(167), rtol=0, atol=STREAM_TOL)


def test_symstream_split_and_carry_over():
    """Consecutive write_samples calls equal one long call (within 1e-6);
    a yagi_tpu stream stopped mid-way continues in the port (load_into)
    with yagi_tpu's samples."""
    t1, t2 = tfr.SymStream(device=DEV), tfr.SymStream(device=DEV)
    one = _np(t1.write_samples(500))
    two = np.concatenate([_np(t2.write_samples(333)), _np(t2.write_samples(167))])
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-6)
    jg = jfr.SymStream()
    jg.write_samples(301)
    tg = load_into(tfr.SymStream(device=DEV), jg, DEV)
    assert tg.msequence.state == jg.msequence.state and tg._carry.shape[0] == len(jg._carry)
    np.testing.assert_allclose(_np(tg.write_samples(400)), jg.write_samples(400), rtol=0,
                               atol=STREAM_TOL)


@pytest.mark.parametrize("bw", [0.25, 0.3, 0.7])
def test_symstreamr_matches(bw):
    """SymStreamR within STREAM_TOL of yagi_tpu's over 1 + 700 + 2000
    samples with set_gain after the first (the power-of-two chunking
    decides where it lands: yagi_tpu's), and continued from a yagi_tpu
    stream carried over mid-way."""
    jg, tg = jfr.SymStreamR(bw=bw), tfr.SymStreamR(bw=bw, device=DEV)
    assert tg.get_delay() == pytest.approx(jg.get_delay(), rel=1e-12)
    assert tg.get_bw_actual() == pytest.approx(jg.get_bw_actual(), rel=1e-12)
    for n, gain in ((1, 0.3), (700, 1.0), (2000, None)):
        np.testing.assert_allclose(_np(tg.write_samples(n)), jg.write_samples(n), rtol=0,
                                   atol=STREAM_TOL)
        if gain is not None:
            jg.set_gain(gain)
            tg.set_gain(gain)
    tc = load_into(tfr.SymStreamR(bw=bw, device=DEV), jg, DEV)
    np.testing.assert_allclose(_np(tc.write_samples(1500)), jg.write_samples(1500), rtol=0,
                               atol=STREAM_TOL)


def test_symstreamr_split_invariance():
    """write_samples(n) twice equals write_samples(2n) (within 1e-6)."""
    a, b = tfr.SymStreamR(bw=0.3, device=DEV), tfr.SymStreamR(bw=0.3, device=DEV)
    one = _np(a.write_samples(4096))
    two = np.concatenate([_np(b.write_samples(2048)), _np(b.write_samples(2048))])
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ _carrier
def test_carrier_helpers_match():
    """The carrier helpers (host numpy) equal yagi_tpu's: the M-th power
    CFO and the phase fit exactly, dd_track within SYM_TOL."""
    rng = np.random.default_rng(21)
    payload, _ = _qpsk_payload(256, seed=22)
    n = np.arange(payload.size)
    rx = (payload * np.exp(1j * (0.01 * n + 0.3)) + _noise(rng, payload.size, 0.05)
          ).astype(np.complex64)
    assert tcarrier.mth_power_cfo(torch.from_numpy(rx)) == jcarrier.mth_power_cfo(rx)
    assert tcarrier.linear_phase_fit(rx[:64], payload[:64]) == jcarrier.linear_phase_fit(
        rx[:64], payload[:64])
    slow = (payload * np.exp(1j * 0.0005 * n)).astype(np.complex64)
    got = tcarrier.dd_track(slow, Modem.create("qpsk", device=DEV))
    np.testing.assert_allclose(got, jcarrier.dd_track(slow, JModem.create("qpsk")), rtol=0,
                               atol=SYM_TOL)


# ------------------------------------------------------------------ errors
_CONFIG_ERRORS = {
    "qdetector short": lambda m, **d: m.QDetector(np.ones(4, np.complex64), **d),
    "qdetector even n_dphi": lambda m, **d: m.QDetector(np.ones(64, np.complex64), n_dphi=4,
                                                        **d),
    "qdetector threshold": lambda m, **d: m.QDetector(np.ones(64, np.complex64), threshold=2.5,
                                                      **d),
    "qdetector short buffer": lambda m, **d: m.QDetector(np.ones(64, np.complex64),
                                                         **d).detect(np.ones(10, np.complex64)),
    "qdsync short": lambda m, **d: m.QDSync(np.ones(4, np.complex64), **d),
    "qdsync k": lambda m, **d: m.QDSync(np.ones(64, np.complex64), k=1, **d),
    "qdsync m": lambda m, **d: m.QDSync(np.ones(64, np.complex64), m=0, **d),
    "qdsync beta": lambda m, **d: m.QDSync(np.ones(64, np.complex64), beta=0.0, **d),
    "qdsync buf_len": lambda m, **d: m.QDSync(np.ones(64, np.complex64), **d).set_buf_len(8),
    "qpilotgen payload": lambda m, **d: m.QPilotGen(0, 16, **d),
    "qpilotgen spacing": lambda m, **d: m.QPilotGen(100, 1, **d),
    "qpilotsync spacing": lambda m, **d: m.QPilotSync(100, 1, **d),
    "qpilotgen length": lambda m, **d: m.QPilotGen(100, 16, **d).execute(
        np.zeros(99, np.complex64)),
    "qpilotsync length": lambda m, **d: m.QPilotSync(100, 16, **d).execute(
        np.zeros(99, np.complex64)),
    "qpacketmodem payload": lambda m, **d: m.QPacketModem(0, **d),
    "symstream k": lambda m, **d: m.SymStream(k=1, **d),
    "symstream m": lambda m, **d: m.SymStream(m=0, **d),
    "symstream beta": lambda m, **d: m.SymStream(beta=1.5, **d),
    "symstreamr bw": lambda m, **d: m.SymStreamR(bw=1.5, **d),
}


@pytest.mark.parametrize("case", sorted(_CONFIG_ERRORS))
def test_config_errors_match(case):
    """Each raises ConfigError in the port where it does in yagi_tpu."""
    make = _CONFIG_ERRORS[case]
    with pytest.raises(JConfigError):
        make(jfr)
    with pytest.raises(ConfigError):
        make(tfr, device=DEV)


def test_no_card_raises_device_error(monkeypatch):
    """With no card and no device, every new device-owning constructor
    raises DeviceError; FRAME64_LEN needs none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = np.ones(64, np.complex64)
    for make in (lambda: tfr.QPacketModem(8), lambda: tfr.QDetector(seq),
                 lambda: tfr.QDSync(seq), lambda: tfr.QPilotGen(100, 16),
                 lambda: tfr.QPilotSync(100, 16), tfr.FrameGen64, tfr.FrameSync64,
                 tfr.SymStream, tfr.SymStreamR):
        with pytest.raises(DeviceError):
            make()
    assert tfr.FRAME64_LEN == tfr.frame64_len() == 1588
