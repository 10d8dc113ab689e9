"""yagi_tpu_torch.fec against yagi_tpu.fec.

The port keeps yagi_tpu's host numpy for the byte and bit work and runs the
Viterbi decoder in torch with yagi_tpu's float32 arithmetic, so every
comparison here is exact (bit for bit): encoded bytes, decoded bytes from
corrupted hard bits and from soft levels, the Viterbi's decoded bits, CRC
keys and flags, the interleavers' permutations, the lengths. The published
known-answer tests of tests/test_fec_kat.py are replayed against the port.
"""

import numpy as np
import pytest
import torch

import yagi_tpu.fec as jfec
from yagi_tpu.fec import conv as jconv
import yagi_tpu_torch.fec as tfec
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.fec import block as tblock
from yagi_tpu_torch.fec import conv as tconv
from yagi_tpu_torch.fec import crc as tcrc
from yagi_tpu_torch.fec.golay import Golay2412
from yagi_tpu_torch.fec.rs import ReedSolomon

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
MSG_LEN = 16
SCHEMES = list(jfec.FecScheme)
_IDS = [s.value for s in SCHEMES]


def _msg(seed: int, n: int = MSG_LEN) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


def _flip(enc: np.ndarray, rng, rate: float) -> np.ndarray:
    """``enc`` with each bit flipped with probability ``rate``."""
    bits = np.unpackbits(enc)
    bits ^= (rng.random(bits.size) < rate).astype(np.uint8)
    return np.packbits(bits)


def _soft(enc: np.ndarray, rng, sigma: float) -> np.ndarray:
    """Soft levels in [0, 1] for the encoded bits (1 = confident one): the
    bits' ±1 levels plus Gaussian noise of std ``sigma``, clipped."""
    bits = np.unpackbits(enc).astype(np.float32)
    lv = bits + np.float32(0.5 * sigma) * rng.standard_normal(bits.size).astype(np.float32)
    return np.clip(lv, 0, 1).astype(np.float32)


@pytest.mark.parametrize("scheme", SCHEMES, ids=_IDS)
def test_encode_and_lengths_equal(scheme):
    """Encoded bytes and every length equal yagi_tpu's exactly."""
    jf, tf = jfec.Fec(scheme), tfec.Fec(scheme, device=DEV)
    msg = _msg(1)
    np.testing.assert_array_equal(tf.encode(msg), jf.encode(msg))
    np.testing.assert_array_equal(tf.encode(bytes(msg)), jf.encode(bytes(msg)))
    assert tf.rate == jf.rate
    for n in (0, 1, 7, 64, 300):
        assert tf.get_enc_msg_length(n) == jf.get_enc_msg_length(n)
        assert tfec.fec_get_enc_msg_length(scheme, n) == jfec.fec_get_enc_msg_length(scheme, n)


@pytest.mark.parametrize("scheme", SCHEMES, ids=_IDS)
def test_decode_hard_equal(scheme):
    """Decoded bytes from corrupted hard bits equal yagi_tpu's exactly:
    clean, at a bit error rate of 1/200 (within most codes' correcting
    power) and of 1/20 (beyond it)."""
    jf, tf = jfec.Fec(scheme), tfec.Fec(scheme, device=DEV)
    msg = _msg(2)
    enc = jf.encode(msg)
    np.testing.assert_array_equal(tf.decode(enc, MSG_LEN), msg)
    rng = np.random.default_rng(3)
    for rate in (1 / 200, 1 / 20):
        bad = _flip(enc, rng, rate)
        np.testing.assert_array_equal(tf.decode(bad, MSG_LEN), jf.decode(bad, MSG_LEN))


@pytest.mark.parametrize("scheme", SCHEMES, ids=_IDS)
def test_decode_soft_equal(scheme):
    """Decoded bytes from soft levels (a numpy array, and a tensor) equal
    yagi_tpu's exactly, at two noise levels."""
    jf, tf = jfec.Fec(scheme), tfec.Fec(scheme, device=DEV)
    msg = _msg(4)
    enc = jf.encode(msg)
    rng = np.random.default_rng(5)
    for sigma in (0.4, 0.9):
        lv = _soft(enc, rng, sigma)
        want = jf.decode_soft(lv, MSG_LEN)
        np.testing.assert_array_equal(tf.decode_soft(lv, MSG_LEN), want)
        np.testing.assert_array_equal(tf.decode_soft(torch.from_numpy(lv), MSG_LEN), want)


_VITERBI = [("conv27", None), ("conv29", None), ("conv39", None), ("conv615", None),
            ("conv27", 3), ("conv29", 7)]


@pytest.mark.parametrize("name,p", _VITERBI, ids=[f"{n}p{p}" if p else n for n, p in _VITERBI])
def test_viterbi_bits_equal(name, p):
    """The port's Viterbi decodes the same bits as ``yagi_tpu.fec.conv._viterbi``
    (all T steps, the flush bits too) from soft levels, hard levels (every
    metric an integer: ties everywhere, all to prev0) and erasures."""
    jc = jconv.conv_punctured(name, p) if p else getattr(jconv, name)()
    tc = tconv.conv_punctured(name, p, DEV) if p else getattr(tconv, name)(DEV)
    L = 8 * (4 if name == "conv615" else MSG_LEN)
    rng = np.random.default_rng(6)
    data = rng.integers(0, 2, L).astype(np.uint8)
    coded = tc.encode_bits(data)
    np.testing.assert_array_equal(coded, jc.encode_bits(data))
    soft = np.clip(coded + 0.45 * rng.standard_normal(coded.size), 0, 1).astype(np.float32)
    hard = (soft > 0.5).astype(np.float32)
    erased = np.where(rng.random(coded.size) < 0.1, np.float32(0.5), hard)
    for lv in (soft, hard, erased):
        np.testing.assert_array_equal(tc.decode_soft(lv, L), jc.decode_soft(lv, L))
    if p is None:  # the whole trellis, flush steps included
        T = L + tc.K - 1
        want = np.asarray(jconv._viterbi(soft.reshape(T, tc.R), jc._expected, jc._prev0,
                                         jc._prev1))
        got = tconv.viterbi(torch.from_numpy(soft).reshape(T, tc.R), tc._expected)
        np.testing.assert_array_equal(got.numpy(), want)


_PACKETIZERS = [("crc32", "none", "none"), ("crc16", "hamming74", "conv27"),
                ("crc32", "hamming128", "conv27p23"), ("crc24", "golay2412", "rs8"),
                ("checksum", "secded7264", "conv29p45"), ("none", "rep3", "conv39")]


@pytest.mark.parametrize("crc,fec0,fec1", _PACKETIZERS)
def test_packetizer_equal(crc, fec0, fec1):
    """Packetizer encode, hard decode and soft decode (numpy levels and a
    tensor) equal yagi_tpu's exactly, payload and CRC flag."""
    jp = jfec.Packetizer(24, crc, fec0, fec1)
    tp = tfec.Packetizer(24, crc, fec0, fec1, device=DEV)
    assert tp.get_enc_msg_length() == jp.get_enc_msg_length()
    msg = _msg(7, 24)
    enc = jp.encode(msg)
    np.testing.assert_array_equal(tp.encode(msg), enc)
    rng = np.random.default_rng(8)
    for bad in (enc, _flip(enc, rng, 1 / 100), _flip(enc, rng, 1 / 12)):
        (jm, jok), (tm, tok) = jp.decode(bad), tp.decode(bad)
        np.testing.assert_array_equal(tm, jm)
        assert tok is jok
    for sigma in (0.5, 1.0):
        lv = _soft(enc, rng, sigma)
        jm, jok = jp.decode_soft(lv)
        for arg in (lv, torch.from_numpy(lv)):
            tm, tok = tp.decode_soft(arg)
            np.testing.assert_array_equal(tm, jm)
            assert tok is jok


@pytest.mark.parametrize("n,depth", [(1, 2), (13, 2), (64, 0), (255, 2)])
def test_interleaver_equal(n, depth):
    """The permutations, byte and soft, equal yagi_tpu's exactly."""
    ji, ti = jfec.Interleaver(n, depth), tfec.Interleaver(n, depth)
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (3, n)).astype(np.uint8)
    np.testing.assert_array_equal(ti.encode(data), ji.encode(data))
    np.testing.assert_array_equal(ti.decode(data), ji.decode(data))
    soft = rng.random((2, 8 * n)).astype(np.float32)
    np.testing.assert_array_equal(ti.encode_soft(soft), ji.encode_soft(soft))
    np.testing.assert_array_equal(ti.decode_soft(soft), ji.decode_soft(soft))


@pytest.mark.parametrize("name", ["hamming74", "hamming84", "hamming128", "hamming1511",
                                  "hamming3126", "secded2216", "secded3932", "secded7264",
                                  "rep3", "rep5", "golay2412"])
def test_block_codes_equal(name):
    """Each block code's codewords, decoded bits and detection flags equal
    yagi_tpu's exactly, on every single and double error of 40 words."""
    jc, tc = getattr(jfec, name)(), getattr(tfec, name)()
    rng = np.random.default_rng(9)
    data = rng.integers(0, 2, (40, jc.k)).astype(np.uint8)
    cw = tc.encode_bits(data)
    np.testing.assert_array_equal(cw, jc.encode_bits(data))
    n = cw.shape[-1]
    bad = np.repeat(cw, 3, axis=0)
    for i, row in enumerate(bad):
        row[rng.choice(n, size=i % 3, replace=False)] ^= 1
    (jd, jdet), (td, tdet) = jc.decode_bits(bad), tc.decode_bits(bad)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tdet, jdet)


def test_crc_keys_equal():
    """Every CRC scheme's key and verdict equal yagi_tpu's."""
    rng = np.random.default_rng(10)
    for n in (0, 1, 9, 100):
        data = rng.integers(0, 256, n).astype(np.uint8)
        for s in jfec.CrcScheme:
            key = tfec.crc_generate_key(s, data)
            assert key == jfec.crc_generate_key(s, data)
            assert tfec.crc_sizeof_key(s) == jfec.crc_sizeof_key(s)
            assert tfec.crc_validate_message(s, data, key)
            assert tfec.crc_validate_message(s, data, key ^ 1) == jfec.crc_validate_message(
                s, data, key ^ 1)


def test_rs_blocks_equal():
    """RS(255,223) codewords of shortened blocks and their decodes (up to
    and past t = 16 symbol errors) equal yagi_tpu's exactly."""
    jr, tr = jfec.rs8(), tfec.rs8()
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (4, 100)).astype(np.int32)
    cw = tr.encode_blocks(data)
    np.testing.assert_array_equal(cw, jr.encode_blocks(data))
    bad = cw.copy()
    for i, nerr in enumerate((0, 5, 16, 20)):
        pos = rng.choice(cw.shape[1], size=nerr, replace=False)
        bad[i, pos] ^= rng.integers(1, 256, nerr)
    (jd, jfail), (td, tfail) = jr.decode_blocks(bad), tr.decode_blocks(bad)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tfail, jfail)


# ---- the published known-answer tests of tests/test_fec_kat.py, on the port
_KAT_MSG = b"123456789"


@pytest.mark.parametrize("fn,value", [("crc8", 0xF4), ("crc16", 0xBB3D),
                                      ("crc32", 0xCBF43926), ("crc24", 0xA41D1B)])
def test_kat_crc_check_values(fn, value):
    """CRC-8/SMBUS, CRC-16/ARC, CRC-32/ISO-HDLC check values; liquid's crc24
    anchor."""
    assert getattr(tcrc, fn)(_KAT_MSG) == value


def test_kat_checksum():
    assert tcrc.checksum(_KAT_MSG) == (-sum(_KAT_MSG)) & 0xFF


def test_kat_golay_weight_enumerator():
    """1 + 759x^8 + 2576x^12 + 759x^16 + x^24, minimum distance 8."""
    msgs = np.arange(4096, dtype=np.uint32)
    bits = ((msgs[:, None] >> np.arange(11, -1, -1)[None, :]) & 1).astype(np.uint8)
    w = Golay2412().encode_bits(bits).sum(axis=1).astype(np.int64)
    expect = np.zeros(25, dtype=int)
    expect[[0, 8, 12, 16, 24]] = (1, 759, 2576, 759, 1)
    np.testing.assert_array_equal(np.bincount(w, minlength=25), expect)


def test_kat_golay_three_errors():
    rng = np.random.default_rng(0)
    g = Golay2412()
    bits = rng.integers(0, 2, size=(50, 12)).astype(np.uint8)
    cw = g.encode_bits(bits)
    for row in range(50):
        r = cw[row].copy()
        r[rng.choice(24, size=3, replace=False)] ^= 1
        np.testing.assert_array_equal(g.decode_bits(r[None, :])[0][0], bits[row])


@pytest.mark.parametrize("maker,n,pairs", [("hamming74", 7, {0: 1, 3: 7, 4: 7, 7: 1}),
                                           ("hamming84", 8, {0: 1, 4: 14, 8: 1})])
def test_kat_hamming_weight_enumerator(maker, n, pairs):
    msgs = np.arange(16, dtype=np.uint32)
    bits = ((msgs[:, None] >> np.arange(3, -1, -1)[None, :]) & 1).astype(np.uint8)
    cw = getattr(tblock, maker)().encode_bits(bits)
    expect = np.zeros(n + 1, dtype=int)
    for k, v in pairs.items():
        expect[k] = v
    np.testing.assert_array_equal(np.bincount(cw.sum(axis=1).astype(np.int64), minlength=n + 1),
                                  expect)


def test_kat_rs_generator_roots():
    """g(x) vanishes exactly on the 32 roots α^(prim·(fcr+i)) of ka9q's
    RS(255,223)."""
    rs = ReedSolomon()
    assert (rs.fcr, rs.prim, rs.nroots) == (112, 11, 32)
    exp, log = rs.gf.exp.astype(np.int64), rs.gf.log.astype(np.int64)

    def gf_eval(poly, xlog):
        acc = 0
        for c in poly:
            if acc:
                acc = int(exp[(int(log[acc]) + xlog) % 255])
            acc ^= int(c)
        return acc

    roots = [(rs.prim * (rs.fcr + i)) % 255 for i in range(rs.nroots)]
    assert all(gf_eval(rs.genpoly, r) == 0 for r in roots)
    assert all(gf_eval(rs.genpoly, r) != 0 for r in [r for r in range(255) if r not in roots][:32])


def test_kat_rs_t16_correction():
    rng = np.random.default_rng(1)
    rs = ReedSolomon()
    data = rng.integers(0, 256, size=(1, 223)).astype(np.uint8)
    r = rs.encode_blocks(data)
    pos = rng.choice(255, size=16, replace=False)
    r[0, pos] ^= rng.integers(1, 256, size=16)
    dec, _ = rs.decode_blocks(r)
    np.testing.assert_array_equal(dec[0, :223], data[0])


# ---- errors
_CONFIG_ERRORS = {
    "packetizer msg_len 0": (lambda m, **d: m.Packetizer(0, **d)),
    "interleaver n 0": (lambda m, **d: m.Interleaver(0)),
    "interleaver depth -1": (lambda m, **d: m.Interleaver(4, -1)),
    "rep4": (lambda m, **d: m.RepetitionCode(4)),
    "hamming k too large": (lambda m, **d: m.LinearBlockCode(3, 5, False, "x")),
    "rs nroots 1": (lambda m, **d: m.ReedSolomon(nroots=1)),
    "conv poly too long": (lambda m, **d: m.ConvCode(3, (0o17,), "x", **d)),
    "puncture base unknown": (lambda m, **d: m.conv_punctured("conv39", 2, **d)),
    "puncture period 8": (lambda m, **d: m.conv_punctured("conv27", 8, **d)),
    "decode wrong length": (lambda m, **d: m.Fec("rs8", **d).decode(np.zeros(3, np.uint8), 8)),
    "dec_len negative": (lambda m, **d: m.fec_get_enc_msg_length("conv27", -1)),
    "packetizer payload length": (lambda m, **d: m.Packetizer(8, **d).encode(np.zeros(7))),
    "soft length": (lambda m, **d: m.Packetizer(8, **d).decode_soft(np.zeros(3))),
}


@pytest.mark.parametrize("case", sorted(_CONFIG_ERRORS))
def test_config_errors_match(case):
    """Each raises ConfigError in the port where it does in yagi_tpu."""
    from yagi_tpu.errors import ConfigError as JConfigError

    make = _CONFIG_ERRORS[case]
    with pytest.raises(JConfigError):
        make(jfec)
    with pytest.raises(ConfigError):
        make(tfec, device=DEV)


def test_no_card_raises_device_error(monkeypatch):
    """With no card and no device, every device-owning constructor raises
    DeviceError; the host-only codecs build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tfec.conv27, tfec.conv615, lambda: tfec.conv_punctured("conv29", 3),
                 lambda: tfec.ConvCode(7, (0o155, 0o117), "x"), lambda: tfec.Fec("conv27"),
                 lambda: tfec.Fec("hamming74"), lambda: tfec.Packetizer(8)):
        with pytest.raises(DeviceError):
            make()
    assert tfec.hamming74().n == 7 and tfec.rs8().k == 223 and tfec.golay2412().n == 24
    assert tfec.Interleaver(8).n == 8
    assert tfec.fec_get_enc_msg_length("conv27p23", 64) == jfec.fec_get_enc_msg_length(
        "conv27p23", 64)
