"""yagi_tpu_torch's bit-level framing (BPacket, BSync), streaming Detector,
multi-signal source (MSource) and byte utilities against yagi_tpu's.

The same numpy-seeded inputs go through yagi_tpu and the port (on the
CPU). Tolerances, and why:

* BPacket (host numpy over the port's packetizer): packets, payloads,
  flags and headers exactly;
* BSync: every sum is of ±1 values, exact in float32 in any order: rxy and
  the carry bit for bit, in one block and split;
* Detector: the detections' count exactly; tau within 1e-4 samples, dphi
  within 1e-6 rad/sample, phi within 1e-5 rad, gamma and rxy within 1e-5
  relative (test_torch_framing.py's: complex64 FFT surfaces from two
  libraries);
* MSource: tones, chirps and noise within 1e-6 (float64 phases and
  filters rounded to complex64 in both; the noise drawn from the same numpy
  generator); a modem source within 1e-5 (SymStreamR's float32 filters in
  two summation orders, test_torch_framing.py's STREAM_TOL);
* byteops (host numpy): exactly.
"""

import copy

import numpy as np
import pytest
import torch

import yagi_tpu.framing as jfr
from yagi_tpu.sequence import MSequence as JMSequence
from yagi_tpu.utils import byteops as jbo
import yagi_tpu_torch.framing as tfr
from yagi_tpu_torch._src.struct import load_into
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.sequence import MSequence
from yagi_tpu_torch.utils import byteops as tbo

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
GEN_TOL = 1e-6
STREAM_TOL = 1e-5
_STAT_ABS = {"tau": 1e-4, "dphi": 1e-6, "phi": 1e-5}
_STAT_REL = {"gamma": 1e-5, "rxy": 1e-5}


# ------------------------------------------------------------------ BPacket
def _bpacket_stream(rng, payload, crc, fec0, fec1, n_err):
    bits = np.unpackbits(jfr.BPacketGen(payload.size, crc, fec0, fec1).encode(payload))
    if n_err:
        bits[rng.choice(bits.size, n_err, replace=False)] ^= 1
    return np.concatenate([rng.integers(0, 2, 101, dtype=np.uint8), bits,
                           rng.integers(0, 2, 57, dtype=np.uint8)])


@pytest.mark.parametrize("crc,fec0,fec1,n_err", [("crc32", "none", "none", 0),
                                                 ("crc32", "hamming84", "conv27", 6),
                                                 ("crc16", "golay2412", "none", 3)])
def test_bpacket_matches(crc, fec0, fec1, n_err):
    """tests/test_buffer_bitsync.py's round trips, clean and with errors:
    the packet's bytes equal yagi_tpu's; fed in seven odd-sized chunks
    after garbage bits, the port's sync calls back once with yagi_tpu's
    payload, flag and header."""
    rng = np.random.default_rng(n_err)
    payload = rng.integers(0, 256, 40, dtype=np.uint8)
    tg = tfr.BPacketGen(40, crc, fec0, fec1, device=DEV)
    pkt = tg.encode(payload)
    assert pkt.size == tg.get_packet_len() == jfr.BPacketGen(40, crc, fec0, fec1).get_packet_len()
    np.testing.assert_array_equal(pkt, jfr.BPacketGen(40, crc, fec0, fec1).encode(payload))
    stream = _bpacket_stream(rng, payload, crc, fec0, fec1, n_err)
    got, want = [], []
    js = jfr.BPacketSync(lambda p, ok, hdr: want.append((p.copy(), ok, hdr)))
    ts = tfr.BPacketSync(lambda p, ok, hdr: got.append((p.copy(), ok, hdr)), device=DEV)
    for chunk in np.array_split(stream, 7):
        js.execute_bits(chunk)
        ts.execute_bits(chunk)
    assert len(got) == len(want) == 1 and ts.num_packets_found == 1
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][0], payload)
    assert got[0][1] is want[0][1] is True
    assert got[0][2] == {"crc": crc, "fec0": fec0, "fec1": fec1, "payload_len": 40}
    assert str(want[0][2]["crc"].value) == crc


def test_bpacket_back_to_back_bytes_and_errors():
    """Two packets of different configurations back to back, decoded by
    one sync; the byte interface; bad lengths raise ConfigError."""
    rng = np.random.default_rng(9)
    p1 = rng.integers(0, 256, 16, dtype=np.uint8)
    p2 = rng.integers(0, 256, 32, dtype=np.uint8)
    b1 = np.unpackbits(tfr.BPacketGen(16, "crc16", "rep3", "none", device=DEV).encode(p1))
    b2 = np.unpackbits(tfr.BPacketGen(32, "crc32", "none", "hamming74", device=DEV).encode(p2))
    got = []
    sync = tfr.BPacketSync(lambda p, ok, hdr: got.append((p.copy(), ok, hdr)), device=DEV)
    sync.execute_bits(np.concatenate([b1, b2]))
    assert len(got) == 2 and got[0][1] and got[1][1]
    np.testing.assert_array_equal(got[0][0], p1)
    np.testing.assert_array_equal(got[1][0], p2)
    assert got[0][2]["fec0"] == "rep3" and got[1][2]["fec1"] == "hamming74"
    payload = np.arange(20, dtype=np.uint8)
    got = []
    sync = tfr.BPacketSync(lambda p, ok, hdr: got.append((p, ok)), device=DEV)
    sync.execute(tfr.BPacketGen(20, device=DEV).encode(payload).tobytes())
    assert len(got) == 1 and got[0][1] and np.array_equal(got[0][0], payload)
    for n in (0, 1 << 16):
        with pytest.raises(ConfigError):
            tfr.BPacketGen(n, device=DEV)


# ------------------------------------------------------------------ BSync
def _bsync_input(complex_: bool, n: int, seed: int, pos: int, seq: np.ndarray):
    rng = np.random.default_rng(seed)
    if complex_:
        x = (np.sign(rng.standard_normal(n)) + 1j * np.sign(rng.standard_normal(n))).astype(
            np.complex64)
        x[pos: pos + seq.size] = seq * (1 + 1j)
        x[5] = 0  # a zero sample counts as +1
    else:
        x = rng.standard_normal(n).astype(np.float32)
        x[pos: pos + seq.size] = seq
        x[5] = 0
    return x


@pytest.mark.parametrize("complex_", [False, True])
def test_bsync_matches_and_splits(complex_):
    """bsync_rrrf/crcf on 2 × 500 samples with a 63-chip m-sequence: rxy and
    the carry equal yagi_tpu's bit for bit; split [n₁, 1, rest] equals one
    block bit for bit; the peak is where yagi_tpu's test expects it."""
    seq = 2.0 * np.asarray(MSequence.create_default(6).generate_bits(63), np.float32) - 1.0
    x = np.stack([_bsync_input(complex_, 500, s, p, seq) for s, p in ((7, 217), (3, 151))])
    js = jfr.BSync.from_msequence(JMSequence.create_default(6))
    ts = tfr.BSync.from_msequence(MSequence.create_default(6), device=DEV)
    want, wstate = js.execute_block(x)
    got, gstate = ts.execute_block(x)
    assert got.dtype == (torch.complex64 if complex_ else torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(gstate if complex_ else (gstate,), wstate if complex_ else (wstate,)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    k = np.argmax(np.abs(got.numpy()), axis=1)
    np.testing.assert_array_equal(k, [217 + 62, 151 + 62])
    state, parts = None, []
    for blk in np.split(x, [97, 98], axis=1):
        r, state = ts.execute_block(blk, state)
        parts.append(r)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), got.numpy())
    # yagi_tpu's carry continues in the port
    jr, jstate = js.execute_block(x[:, :300])
    tr, _ = ts.execute_block(x[:, 300:], jstate)
    np.testing.assert_array_equal(tr.numpy(), got.numpy()[:, 300:])


def test_bsync_config_and_default_device():
    with pytest.raises(ConfigError):
        tfr.BSync(np.zeros(0), device=DEV)
    r, c = tfr.BSync([1.0, -1.0, 0.0], device=DEV).execute_block(np.ones(4, np.float32))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jfr.BSync([1.0, -1.0, 0.0]).execute_block(
        np.ones(4, np.float32))[0]))
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            tfr.BSync([1.0, -1.0])


# ------------------------------------------------------------------ Detector
def _same_detections(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if k in _STAT_REL:
                assert g[k] == pytest.approx(v, rel=_STAT_REL[k]), k
            elif k == "phi":
                assert abs(np.angle(np.exp(1j * (g[k] - v)))) < _STAT_ABS[k], k
            else:
                assert abs(g[k] - v) < _STAT_ABS[k], k


def test_detector_two_bursts_across_blocks():
    """tests/test_buffer_bitsync.py's case: two bursts, the second across
    the 1024-sample block boundary, fed in two blocks: yagi_tpu's
    detections; a quiet stream after reset gives none."""
    rng = np.random.default_rng(11)
    s = np.exp(2j * np.pi * rng.random(80)).astype(np.complex64)
    rng = np.random.default_rng(5)
    x = 0.05 * (rng.standard_normal(2000) + 1j * rng.standard_normal(2000)).astype(np.complex64)
    n = np.arange(s.size)
    for t in (300, 1010):
        x[t: t + s.size] += 0.9 * s * np.exp(1j * 0.01 * n)
    jd = jfr.Detector(s, threshold=0.5, dphi_max=0.02, n_dphi=9)
    td = tfr.Detector(s, threshold=0.5, dphi_max=0.02, n_dphi=9, device=DEV)
    want = jd.execute(x[:1024]) + jd.execute(x[1024:])
    got = td.execute(torch.from_numpy(x[:1024])) + td.execute(x[1024:])
    _same_detections(got, want)
    assert [round(d["tau"]) for d in got] == [300, 1010]
    assert td._offset == jd._offset and td._tail.shape[0] == jd._tail.size
    td.reset()
    quiet = (0.05 * (rng.standard_normal(500) + 1j * rng.standard_normal(500))).astype(
        np.complex64)
    assert td.execute(quiet) == [] and jd.execute(quiet) == []


def test_detector_many_bursts_and_carry_over():
    """Six bursts at random leads in 4 blocks, several to a block (the
    greedy pick and the debounce): yagi_tpu's detections in order; a
    yagi_tpu detector stopped after two blocks continues in the port
    (load_into: its tail and offset)."""
    rng = np.random.default_rng(21)
    s = ((1 - 2 * rng.integers(0, 2, 64)) + 1j * (1 - 2 * rng.integers(0, 2, 64))).astype(
        np.complex64) / np.float32(np.sqrt(2))
    x = (0.05 * (rng.standard_normal(4000) + 1j * rng.standard_normal(4000))).astype(np.complex64)
    for t, g, d in zip((100, 380, 900, 1250, 2600, 3333), (0.9, 0.5, 1.2, 0.7, 1.0, 0.6),
                       (0.01, -0.015, 0.0, 0.004, -0.007, 0.012)):
        x[t: t + 64] += (g * s * np.exp(1j * (d * np.arange(64) + t))).astype(np.complex64)
    blocks = np.split(x, [700, 1300, 2700])
    jd, td = jfr.Detector(s, n_dphi=9), tfr.Detector(s, n_dphi=9, device=DEV)
    want = [d for b in blocks for d in jd.execute(b)]
    got = [d for b in blocks for d in td.execute(b)]
    _same_detections(got, want)
    assert len(got) == 6
    jd.reset()
    for b in blocks[:2]:
        jd.execute(b)
    tc = load_into(tfr.Detector(s, n_dphi=9, device=DEV), jd, DEV)
    _same_detections([d for b in blocks[2:] for d in tc.execute(b)],
                     [d for b in blocks[2:] for d in jd.execute(b)])


@pytest.mark.parametrize("n", [64, 167, 512])
def test_detector_reference_scenarios(n):
    """test_framing2.py's detector_cccf_n* scenarios: yagi_tpu's detections."""
    rng = np.random.default_rng(n + 3)
    s = ((1 - 2 * rng.integers(0, 2, n)) + 1j * (1 - 2 * rng.integers(0, 2, n))).astype(
        np.complex64) / np.float32(np.sqrt(2))
    tau = n // 2 + 7
    buf = 0.02 * (rng.normal(size=3 * n) + 1j * rng.normal(size=3 * n)).astype(np.complex64)
    buf[tau: tau + n] += 0.8 * s
    buf = buf.astype(np.complex64)
    want = jfr.Detector(s, threshold=0.5).execute(buf)
    got = tfr.Detector(s, threshold=0.5, device=DEV).execute(buf)
    _same_detections(got, want)
    assert any(abs(h["tau"] - tau) <= 2 for h in got)
    with pytest.raises(ConfigError):
        tfr.Detector(s, max_detections_per_block=0, device=DEV)


# ------------------------------------------------------------------ MSource
def _pair(seed):
    return jfr.MSource(seed=seed), tfr.MSource(seed=seed, device=DEV)


def _same_stream(j, t, blocks, tol=GEN_TOL):
    for n in blocks:
        want, got = j.write_samples(n), t.write_samples(n)
        assert got.dtype == torch.complex64 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_msource_tone_and_chirp_match():
    """A tone and a repeating and a single negated chirp, over blocks 1000,
    1 and 3000: yagi_tpu's samples."""
    j, t = _pair(1)
    for src in (j, t):
        src.add_tone(fc=0.2, gain_db=-3.0)
        src.add_chirp(fc=-0.1, bw=0.2, gain_db=-6.0, duration=777.5)
        src.add_chirp(fc=0.05, bw=0.1, duration=900.0, negate=True, repeat=False)
    _same_stream(j, t, (1000, 1, 3000))


def test_msource_aggregate_noise_match():
    """Band-limited noise (filtered, and the full band), a tone and a
    disabled source, over blocks 513, 0 and 2048: yagi_tpu's samples (the
    same numpy noise draws in the same order)."""
    j, t = _pair(3)
    for src in (j, t):
        src.add_noise(fc=0.15, bw=0.1, gain_db=-10.0)
        src.add_tone(fc=-0.3)
        src.add_noise(fc=0.0, bw=1.0, gain_db=-30.0)
        muted = src.add_noise(fc=-0.2, bw=0.3)
        src.disable(muted)
    _same_stream(j, t, (513, 0, 2048))
    for src in (j, t):
        src.enable(muted)
    _same_stream(j, t, (700,))


def test_msource_modem_source_matches():
    """A QPSK modem source (the port's SymStreamR) beside a tone: within
    STREAM_TOL of yagi_tpu's; remove and the count as yagi_tpu."""
    j, t = _pair(4)
    for src in (j, t):
        sid = src.add_modem("qpsk", fc=-0.2, bw=0.1, gain_db=-3.0)
        src.add_tone(fc=0.3)
        assert src.get_num_sources() == 2
    _same_stream(j, t, (1500, 700), tol=STREAM_TOL)
    t.remove(sid)
    assert t.get_num_sources() == 1
    with pytest.raises(ConfigError):
        t.remove(sid)


def test_msource_copy_and_carry_over():
    """A deep copy continues identically (liquid msourcecf_copy); a
    yagi_tpu source stopped mid-stream continues in the port with
    yagi_tpu's samples (load_into: each source's phase, the noise tail and
    chirp time, the numpy generator)."""
    j, t = _pair(5)
    for src in (j, t):
        src.add_tone(fc=0.2)
        src.add_chirp(fc=-0.1, bw=0.1, duration=500.0)
        src.add_noise(fc=0.3, bw=0.05, gain_db=-6.0)
    t.write_samples(700)
    t1 = copy.deepcopy(t)
    assert torch.equal(t.write_samples(300), t1.write_samples(300))
    j.write_samples(901)
    tc = tfr.MSource(seed=99, device=DEV)
    tc.add_tone(fc=0.2)
    tc.add_chirp(fc=-0.1, bw=0.1, duration=500.0)
    tc.add_noise(fc=0.3, bw=0.05, gain_db=-6.0)
    load_into(tc, j, DEV)
    _same_stream(j, tc, (640,))


def test_msource_errors_and_default_device():
    src = tfr.MSource(device=DEV)
    for bad in (lambda: src.add_tone(fc=0.7), lambda: src.add_noise(fc=0.0, bw=0.0),
                lambda: src.add_chirp(fc=0.0, bw=0.1, duration=0.5),
                lambda: src.add_chirp(fc=0.0, bw=1.5)):
        with pytest.raises(ConfigError):
            bad()
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            tfr.MSource()


# ------------------------------------------------------------------ byteops
def test_byteops_match():
    """Every byteops function on random inputs equals yagi_tpu's; the
    module exports the same 16 names."""
    assert tbo.__all__ == jbo.__all__ and len(tbo.__all__) == 16
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, 23).astype(np.uint8)
    for k in (1, 3, 7, 8, 12, 32):
        sym = rng.integers(0, 1 << min(k, 31), 17).astype(np.uint64)
        np.testing.assert_array_equal(tbo.pack_bytes(sym, k), jbo.pack_bytes(sym, k))
        np.testing.assert_array_equal(tbo.unpack_bytes(data, k), jbo.unpack_bytes(data, k))
        for k_out in (1, 5, 8, 13):
            np.testing.assert_array_equal(tbo.repack_bytes(sym, k, k_out),
                                          jbo.repack_bytes(sym, k, k_out))
    np.testing.assert_array_equal(tbo.pack_array(data, 13, 7, 91), jbo.pack_array(data, 13, 7, 91))
    assert tbo.unpack_array(data, 29, 11) == jbo.unpack_array(data, 29, 11)
    for name in ("lshift", "rshift", "lcircshift", "rcircshift", "lbshift", "rbshift",
                 "lbcircshift", "rbcircshift"):
        for b in (0, 3, 9, 30, 500):
            np.testing.assert_array_equal(getattr(tbo, name)(data, b), getattr(jbo, name)(data, b))
    theta = np.angle(np.exp(1j * np.cumsum(rng.normal(0, 2, 300))))
    np.testing.assert_array_equal(tbo.unwrap_phase(theta), jbo.unwrap_phase(theta))
    x = rng.normal(size=77).astype(np.float32)
    z = (x + 1j * rng.normal(size=77)).astype(np.complex64)
    assert tbo.sumsqf(x) == jbo.sumsqf(x) and tbo.sumsqcf(z) == jbo.sumsqcf(z)
    for bad in (lambda: tbo.pack_bytes(data, 0), lambda: tbo.unpack_bytes(data, 40),
                lambda: tbo.unpack_bytes(data, 8, n=24), lambda: tbo.pack_array(data, 180, 8, 1)):
        with pytest.raises(ConfigError):
            bad()
