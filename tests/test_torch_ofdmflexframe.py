"""yagi_tpu_torch.multichannel's OFDM flexible frame against yagi_tpu's.

The same numpy-seeded buffers go through yagi_tpu's object and the port's
(on the CPU). Tolerances:

* bytes, CRC flags, payload properties, detection or not: exactly;
* generated frames (complex64): within 1e-6 (the packet modem's symbols
  exactly, then two FFT libraries in float64);
* stats: the timing offset tau exactly, the CFO, RSSI, pilot EVM and S1
  correlation within 1e-9 relative (test_torch_ofdm.py's, both in
  complex128).

The port's OFDM pilot fit is repaired at ±π (test_torch_ofdm.py::
test_pilot_fit_at_pi_repaired); these frames are short enough that no
symbol's phase reaches ±π, so the two agree.
"""

import numpy as np
import pytest
import torch

from yagi_tpu.multichannel import OfdmFlexFrameGen as JGen, OfdmFlexFrameSync as JSync
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.multichannel import OfdmFlexFrameGen, OfdmFlexFrameSync

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
GEN_TOL = 1e-6
STAT_REL = 1e-9


def _channel(tx, delay, cfo, phi, snr_db, seed, taps=None):
    """tests/test_ofdmflexframe.py's channel."""
    rng = np.random.default_rng(seed)
    buf = np.concatenate([np.zeros(delay, np.complex64), tx, np.zeros(64, np.complex64)])
    if taps is not None:
        buf = np.convolve(buf, taps)[: buf.size]
    n = np.arange(buf.size)
    buf = buf * np.exp(1j * (cfo * n + phi))
    nstd = 10 ** (-snr_db / 20) / np.sqrt(2)
    buf = buf + nstd * (rng.standard_normal(buf.size) + 1j * rng.standard_normal(buf.size))
    return buf.astype(np.complex64)


def _same_result(got, want) -> None:
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
    assert got["props"] == want["props"]
    assert got["stats"]["tau"] == want["stats"]["tau"]
    for k in ("cfo", "rssi_db", "evm_pilots_db", "rxy"):
        assert got["stats"][k] == pytest.approx(want["stats"][k], rel=STAT_REL, abs=1e-12), k


@pytest.mark.parametrize("M,cp,mod,fec0,plen", [(64, 16, "qpsk", "none", 64),
                                                (64, 16, "qam16", "hamming128", 100)])
def test_roundtrip_matches(M, cp, mod, fec0, plen):
    """The first two cases of tests/test_ofdmflexframe.py's grid: the frame
    within GEN_TOL of yagi_tpu's; the port's sync on yagi_tpu's buffer
    gives yagi_tpu's result, and the payload and props come back."""
    rng = np.random.default_rng(M + plen)
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, plen).astype(np.uint8)
    tx = JGen(M=M, cp_len=cp, header_len=14).assemble(header, payload, mod_scheme=mod,
                                                        crc="crc32", fec0=fec0, fec1="none")
    got_tx = OfdmFlexFrameGen(M=M, cp_len=cp, header_len=14, device=DEV).assemble(
        header, payload, mod_scheme=mod, crc="crc32", fec0=fec0, fec1="none")
    assert got_tx.dtype == torch.complex64
    np.testing.assert_allclose(got_tx.numpy(), np.asarray(tx), rtol=0, atol=GEN_TOL)
    rx = _channel(np.asarray(tx), delay=3 * cp, cfo=0.002, phi=0.9, snr_db=30, seed=plen)
    want = JSync(M=M, cp_len=cp, header_len=14).execute(rx)
    got = OfdmFlexFrameSync(M=M, cp_len=cp, header_len=14, device=DEV).execute(
        torch.from_numpy(rx))
    _same_result(got, want)
    assert got["payload_valid"] and (got["payload"] == payload).all()
    assert got["props"] == {"mod_scheme": mod, "crc": "crc32", "fec0": fec0, "fec1": "none",
                            "payload_len": plen}


def test_multipath_matches():
    """3-tap multipath, absorbed by the one-tap S1 equalizer, as
    tests/test_ofdmflexframe.py::test_multipath."""
    rng = np.random.default_rng(1)
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, 80).astype(np.uint8)
    tx = np.asarray(JGen(M=64, cp_len=16).assemble(header, payload, mod_scheme="qpsk",
                                                     fec0="hamming128"))
    taps = np.array([1.0, 0.25 - 0.15j, -0.1 + 0.08j], np.complex64)
    rx = _channel(tx, delay=40, cfo=-0.0015, phi=0.3, snr_db=28, seed=2, taps=taps)
    want = JSync(M=64, cp_len=16).execute(rx)
    got = OfdmFlexFrameSync(M=64, cp_len=16, device=DEV).execute(rx)
    _same_result(got, want)
    assert got["payload_valid"] and (got["payload"] == payload).all()


def test_short_buffer_no_detection_and_truncated_payload():
    """A short buffer and noise give None in both; a buffer that ends in
    the payload gives the header and props with no payload, as yagi_tpu."""
    assert OfdmFlexFrameSync(device=DEV).execute(np.zeros(100, np.complex64)) is None
    rng = np.random.default_rng(0)
    noise = (0.01 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))).astype(
        np.complex64)
    assert JSync().execute(noise) is None and OfdmFlexFrameSync(device=DEV).execute(noise) is None
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, 300).astype(np.uint8)
    tx = np.asarray(JGen().assemble(header, payload))
    rx = _channel(tx, delay=48, cfo=0.001, phi=0.2, snr_db=30, seed=4)[: 48 + tx.size // 2]
    want, got = JSync().execute(rx), OfdmFlexFrameSync(device=DEV).execute(rx)
    _same_result(got, want)
    assert got["header_valid"] and got["payload"] is None and got["props"]["payload_len"] == 300


def test_config_errors_and_default_device():
    gen = OfdmFlexFrameGen(M=64, cp_len=16, header_len=8, device=DEV)
    for h, p, kw in ((np.zeros(7, np.uint8), np.zeros(10, np.uint8), {}),
                     (np.zeros(8, np.uint8), np.zeros(0, np.uint8), {}),
                     (np.zeros(8, np.uint8), np.zeros(8, np.uint8), {"crc": "bogus"})):
        with pytest.raises(ConfigError):
            gen.assemble(h, p, **kw)
    with pytest.raises(ConfigError):
        OfdmFlexFrameGen(M=4, device=DEV)
    with pytest.raises(ConfigError):
        OfdmFlexFrameGen(header_len=-1, device=DEV)
    if not torch.cuda.is_available():
        for make in (OfdmFlexFrameGen, OfdmFlexFrameSync):
            with pytest.raises(DeviceError):
                make()


def test_long_frame_pilot_fit_at_pi_repaired():
    """Shared fault, repaired in the port (ROADMAP queue 3): a 3072-byte
    qpsk frame (272 OFDM symbols) through chip_smoke.py's [frames] channel
    (taps (1, 0.1j, −0.05), CFO 0.004, 30 dB; numpy seed 99, the third
    draw). The residual carrier offset carries some symbols' common phase
    past ±π: yagi_tpu's pilot fit over the raw angles loses them and the
    payload fails its CRC; the port's fit about the circular mean decodes
    the frame."""
    from yagi_tpu_torch.channel import Channel

    rng = np.random.default_rng(99)
    gen = torch.Generator().manual_seed(99)
    og = OfdmFlexFrameGen(64, 16, device=DEV)
    for _ in range(3):
        header = rng.integers(0, 256, 14).astype(np.uint8)
        payload = rng.integers(0, 256, 3072).astype(np.uint8)
        tx = og.assemble(header, payload, "qpsk")
        lead = int(rng.integers(64, 1024))
        buf = torch.zeros(lead + tx.shape[0] + 300, dtype=torch.complex64)
        buf[lead: lead + tx.shape[0]] = tx
        snr = 30.0 - 10 * np.log10(float(tx.abs().square().mean()))
        ch = Channel.create(snr, 0.004, float(rng.uniform(-np.pi, np.pi)),
                            (1.0, 0.1j, -0.05), device=DEV)
        rx, _ = ch.execute(gen, buf)
    want = JSync(64, 16).execute(rx.numpy())
    assert want["header_valid"] and not want["payload_valid"]
    got = OfdmFlexFrameSync(64, 16, device=DEV).execute(rx)
    assert got["payload_valid"] and (got["payload"] == payload).all()
    assert got["stats"]["tau"] == want["stats"]["tau"] == lead
    np.testing.assert_array_equal(got["header"], want["header"])
