"""yagi_tpu_torch.framing's dsssframe64 and fskframe against yagi_tpu's.

The same numpy-seeded buffers go through yagi_tpu's object and the port's
(on the CPU). Tolerances, and why (test_torch_framing.py's):

* bytes, CRC flags, payload properties, the FSK preamble match, detection
  or not: exactly;
* DSSS samples: within 1e-6 (yagi_tpu shapes in numpy complex64, the port
  in complex128 rounded to complex64); FSK samples: exactly (the same u32
  phase words, one float32 exp);
* detection stats: tau within 1e-4 samples, dphi within 1e-6 rad/sample,
  phi within 1e-5 rad, gamma and rxy within 1e-5 relative, evm_db within
  1e-3 dB (the correlation surface is a complex64 FFT in both).

One case departs from yagi_tpu on purpose: DSSS's preamble fit takes the
chips' raw angles, and the port references the carrier ramp at the burst
(test_dsss_phase_reference_repaired), where yagi_tpu loses a frame whose
residual phase sits at ±π.
"""

import copy

import numpy as np
import pytest
import torch

import yagi_tpu.framing as jfr
import yagi_tpu_torch.framing as tfr
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.tools.paths import impair

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
GEN_TOL = 1e-6
_STAT_ABS = {"tau": 1e-4, "dphi": 1e-6, "phi": 1e-5, "evm_db": 1e-3}
_STAT_REL = {"gamma": 1e-5, "rxy": 1e-5}


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
    assert sorted(got["stats"]) == sorted(want["stats"])
    for k, w in want["stats"].items():
        g = got["stats"][k]
        if k in _STAT_REL:
            assert g == pytest.approx(w, rel=_STAT_REL[k]), k
        elif k == "phi":
            assert abs(np.angle(np.exp(1j * (g - w)))) < _STAT_ABS[k], k
        elif k in _STAT_ABS:
            assert abs(g - w) < _STAT_ABS[k], k
        else:
            assert g == w, k


def _channel(tx, delay, dphi, phi, gamma, snr_db, seed):
    """tests/test_dsss_fskframe.py's channel."""
    rng = np.random.default_rng(seed)
    buf = np.concatenate([np.zeros(delay, np.complex64), tx, np.zeros(64, np.complex64)])
    n = np.arange(buf.size)
    buf = gamma * buf * np.exp(1j * (dphi * n + phi))
    nstd = 10 ** (-snr_db / 20) / np.sqrt(2)
    buf = buf + nstd * (rng.standard_normal(buf.size) + 1j * rng.standard_normal(buf.size))
    return buf.astype(np.complex64)


def _bytes(seed, n_hdr, n_pld):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, n_hdr).astype(np.uint8),
            rng.integers(0, 256, n_pld).astype(np.uint8))


# ------------------------------------------------------------------ DSSS
@pytest.mark.parametrize("sf", [4, 8, 16])
def test_dsss_matches(sf):
    """tests/test_dsss_fskframe.py's round trip at sf 4, 8 and 16: the
    generator within GEN_TOL of yagi_tpu's, the port's sync on yagi_tpu's
    buffer equal to yagi_tpu's result, and the frame decoded."""
    header, payload = _bytes(sf, 8, 64)
    jg, tg = jfr.DsssFrameGen64(sf=sf), tfr.DsssFrameGen64(sf=sf, device=DEV)
    tx = jg.execute(header, payload)
    got_tx = tg.execute(header, payload)
    assert tg.frame_len == jg.frame_len == got_tx.shape[0] and got_tx.dtype == torch.complex64
    np.testing.assert_allclose(got_tx.numpy(), tx, rtol=0, atol=GEN_TOL)
    rx = _channel(tx, delay=83, dphi=0.001, phi=0.8, gamma=0.9, snr_db=20, seed=sf)
    want = jfr.DsssFrameSync64(sf=sf).execute(rx)
    got = tfr.DsssFrameSync64(sf=sf, device=DEV).execute(torch.from_numpy(rx))
    _same_result(got, want)
    assert got["header_valid"] and got["payload_valid"]
    np.testing.assert_array_equal(got["header"], header)
    np.testing.assert_array_equal(got["payload"], payload)


def test_dsss_low_snr_processing_gain():
    """yagi_tpu's 2-dB case at sf 16 (threshold 0.25): decoded thanks to
    the ~12 dB spreading gain, with yagi_tpu's bytes and stats."""
    header, payload = _bytes(4, 8, 64)
    tx = jfr.DsssFrameGen64(sf=16).execute(header, payload)
    rx = _channel(tx, delay=50, dphi=0.0005, phi=-0.4, gamma=1.0, snr_db=2, seed=5)
    want = jfr.DsssFrameSync64(sf=16, threshold=0.25).execute(rx)
    got = tfr.DsssFrameSync64(sf=16, threshold=0.25, device=DEV).execute(rx)
    _same_result(got, want)
    assert got["payload_valid"] and (got["payload"] == payload).all()


def test_dsss_phase_reference_repaired():
    """Shared fault, repaired in the port (ROADMAP queue 3): DSSS's
    preamble fit takes the 256 chips' raw angles, and yagi_tpu derotates by
    e^{−j(dphi·n + phi)} from the buffer's start while phi is the carrier's
    phase at the burst; at a lead of 349 with dphi 0.009 the constant
    phase left on the chips sits near ±π, the fit fails and yagi_tpu loses
    the frame (preamble EVM ~ +4 dB). The port references the ramp at tau
    and decodes it. The buffer: tools/paths.py's impairments (20 dB), torch
    noise seed 0."""
    header, payload = _bytes(0, 8, 64)
    tx = tfr.DsssFrameGen64(sf=8, device=DEV).execute(header, payload)
    draw = dict(lead=349, tau=0.5, dphi=0.009, phi=-0.78, gain=1.0)
    buf = impair(tx, draw, tx.shape[0] + 1000, torch.Generator().manual_seed(0), snr_db=20.0)
    want = jfr.DsssFrameSync64(sf=8).execute(buf.numpy())
    assert want is not None and not want["payload_valid"] and want["stats"]["evm_db"] > 0
    got = tfr.DsssFrameSync64(sf=8, device=DEV).execute(buf)
    assert got["header_valid"] and got["payload_valid"]
    np.testing.assert_array_equal(got["header"], header)
    np.testing.assert_array_equal(got["payload"], payload)
    assert abs(got["stats"]["dphi"] - draw["dphi"]) < 1e-3 and got["stats"]["evm_db"] < -15
    # away from ±π the two references agree (lead 400, as yagi_tpu)
    draw["lead"] = 400
    buf = impair(tx, draw, tx.shape[0] + 1000, torch.Generator().manual_seed(0), snr_db=20.0)
    _same_result(tfr.DsssFrameSync64(sf=8, device=DEV).execute(buf),
                 jfr.DsssFrameSync64(sf=8).execute(buf.numpy()))


def test_dsss_copy_noise_and_errors():
    """A deep copy decodes identically; noise gives None in both; bad
    configurations raise ConfigError."""
    header, payload = _bytes(33, 8, 64)
    g0 = tfr.DsssFrameGen64(sf=4, device=DEV)
    t0 = g0.execute(header, payload)
    assert torch.equal(copy.deepcopy(g0).execute(header, payload), t0)
    rx = _channel(t0.numpy(), delay=40, dphi=0.0, phi=0.3, gamma=1.0, snr_db=25, seed=34)
    s0 = tfr.DsssFrameSync64(sf=4, device=DEV)
    r0, r1 = s0.execute(rx), copy.deepcopy(s0).execute(rx)
    np.testing.assert_array_equal(r0["payload"], r1["payload"])
    rng = np.random.default_rng(0)
    noise = (0.01 * (rng.standard_normal(8192) + 1j * rng.standard_normal(8192))).astype(
        np.complex64)
    assert jfr.DsssFrameSync64(sf=8).execute(noise) is None
    assert tfr.DsssFrameSync64(sf=8, device=DEV).execute(noise) is None
    with pytest.raises(ConfigError):
        tfr.DsssFrameGen64(sf=1, device=DEV)
    with pytest.raises(ConfigError):
        tfr.DsssFrameSync64(sf=512, device=DEV)
    gen = tfr.DsssFrameGen64(sf=8, device=DEV)
    with pytest.raises(ConfigError):
        gen.execute(np.zeros(7, np.uint8), np.zeros(64, np.uint8))
    with pytest.raises(ConfigError):
        gen.execute(np.zeros(8, np.uint8), np.zeros(63, np.uint8))


# ------------------------------------------------------------------ FSK
@pytest.mark.parametrize("m,k,bw", [(1, 8, 0.25), (2, 8, 0.25), (1, 4, 0.2), (3, 16, 0.3)])
def test_fsk_matches(m, k, bw):
    """tests/test_dsss_fskframe.py's FSK round trips (m 1 and 2, and its
    other cases): the generator equal to yagi_tpu's, the port's sync on
    yagi_tpu's buffer equal to yagi_tpu's result, the frame decoded."""
    header, payload = _bytes(m * 10 + k, 8, 32)
    tx = np.asarray(jfr.FskFrameGen(m=m, k=k, bandwidth=bw, header_len=8).assemble(
        header, payload, crc="crc32", fec0="hamming74"))
    got_tx = tfr.FskFrameGen(m=m, k=k, bandwidth=bw, header_len=8, device=DEV).assemble(
        header, payload, crc="crc32", fec0="hamming74")
    np.testing.assert_allclose(got_tx.numpy(), tx, rtol=0, atol=GEN_TOL)
    rx = _channel(tx, delay=60, dphi=0.004, phi=1.3, gamma=1.5, snr_db=25, seed=k)
    want = jfr.FskFrameSync(m=m, k=k, bandwidth=bw, header_len=8).execute(rx)
    got = tfr.FskFrameSync(m=m, k=k, bandwidth=bw, header_len=8, device=DEV).execute(rx)
    _same_result(got, want)
    assert got["payload_valid"] and (got["payload"] == payload).all()
    assert got["props"] == {"crc": "crc32", "fec0": "hamming74", "fec1": "none",
                            "payload_len": 32}


def test_fsk_byte_symbol_helpers_match():
    """The symbol↔byte helpers equal yagi_tpu's at m = 1 … 4."""
    from yagi_tpu.framing import fskframe as jfsk
    from yagi_tpu_torch.framing import fskframe as tfsk

    data = np.random.default_rng(2).integers(0, 256, 37).astype(np.uint8)
    for m in (1, 2, 3, 4):
        np.testing.assert_array_equal(tfsk._preamble_symbols(m), jfsk._preamble_symbols(m))
        s = tfsk._bytes_to_syms(data, m)
        np.testing.assert_array_equal(s, jfsk._bytes_to_syms(data, m))
        np.testing.assert_array_equal(tfsk._syms_to_bytes(s, m, 37), data)


def test_fsk_gain_phase_noise_and_errors():
    """Non-coherent: decodes at any carrier phase and gain (yagi_tpu's
    test); noise gives None; bad arguments raise ConfigError."""
    header, payload = _bytes(9, 8, 20)
    tx = tfr.FskFrameGen(m=1, k=8, bandwidth=0.25, device=DEV).assemble(header, payload)
    sync = tfr.FskFrameSync(m=1, k=8, bandwidth=0.25, device=DEV)
    for phi, gamma in [(0.0, 0.1), (2.5, 3.0), (-1.0, 0.5)]:
        rx = _channel(tx.numpy(), 31, 0.0, phi, gamma, 30, int(phi * 10) & 0xFF)
        res = sync.execute(rx)
        assert res is not None and res["payload_valid"]
        np.testing.assert_array_equal(res["payload"], payload)
    rng = np.random.default_rng(1)
    noise = (0.01 * (rng.standard_normal(8192) + 1j * rng.standard_normal(8192))).astype(
        np.complex64)
    assert sync.execute(noise) is None and jfr.FskFrameSync().execute(noise) is None
    with pytest.raises(ConfigError):
        tfr.FskFrameGen(m=0, device=DEV)
    with pytest.raises(ConfigError):
        tfr.FskFrameGen(header_len=-1, device=DEV)
    gen = tfr.FskFrameGen(device=DEV)
    with pytest.raises(ConfigError):
        gen.assemble(np.zeros(7, np.uint8), np.zeros(10, np.uint8))
    with pytest.raises(ConfigError):
        gen.assemble(np.zeros(8, np.uint8), np.zeros(4, np.uint8), fec0="bogus")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (tfr.DsssFrameGen64, tfr.DsssFrameSync64, tfr.FskFrameGen, tfr.FskFrameSync):
        with pytest.raises(DeviceError):
            make()
