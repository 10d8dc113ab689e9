"""yagi_tpu_torch.sequence and the native bsequence ABI against yagi_tpu, on
the CPU, exact: MSequence for every default polynomial (m = 2 … 31: bits,
symbols, the period, the state carried over through get_state/set_state),
BSequence's constructors and operations, and the port's NativeBSequence
(its own build of native/bsequence.cpp) against the port's BSequence and
against yagi_tpu's NativeBSequence.
"""

import numpy as np
import pytest
import torch

from yagi_tpu.native import NativeBSequence as JNative
from yagi_tpu.sequence import BSequence as JB
from yagi_tpu.sequence import MSequence as JM
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.native import NativeBSequence, native_available
from yagi_tpu_torch.sequence import BSequence, MSequence

torch.set_num_threads(1)


@pytest.mark.parametrize("m", range(2, 32))
def test_msequence_default_matches(m):
    j, t = JM.create_default(m), MSequence.create_default(m)
    assert (t.m, t.g, t.n, t.get_length(), t.get_genpoly(), t.get_genpoly_length()) == (
        j.m, j.g, j.n, j.get_length(), j.get_genpoly(), j.get_genpoly_length())
    np.testing.assert_array_equal(t.generate_bits(97), j.generate_bits(97))
    got, want = t.generate_symbols(5, 40), j.generate_symbols(5, 40)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert t.measure_period() == j.measure_period() == (1 << m) - 1
    # the state carried over: yagi_tpu's object drives a few steps, the port's
    # is built from its state through the public accessors and follows it
    for _ in range(13):
        j.advance()
    t2 = MSequence.create_genpoly(j.get_genpoly())
    t2.set_state(j.get_state())
    assert t2.get_state() == j.get_state()
    assert [t2.generate_symbol(3) for _ in range(20)] == [j.generate_symbol(3) for _ in range(20)]
    t2.reset()
    j.reset()
    assert t2.get_state() == j.get_state() == 1


def test_msequence_non_primitive_and_errors():
    # 0b1111 (x^4 + x^3 + x^2 + x + 1) is not primitive: the direct count
    for g in (0b1111, 0b1001, 0b11000):
        assert MSequence.create_genpoly(g).measure_period() == JM.create_genpoly(g).measure_period()
    t, j = MSequence(5, 0x14, a=7), JM(5, 0x14, a=7)
    t.set_state(0xFFFF)
    j.set_state(0xFFFF)
    assert t.get_state() == j.get_state()
    for bad in (1, 32):
        with pytest.raises(ConfigError):
            MSequence.create_default(bad)
    with pytest.raises(ConfigError):
        MSequence.create_genpoly(1)
    with pytest.raises(ConfigError):
        MSequence(40, 3)


def _same(t: BSequence, j: JB):
    assert t.get_length() == j.get_length() and t.num_bits_msb == j.num_bits_msb
    np.testing.assert_array_equal(t.s, j.s)
    np.testing.assert_array_equal(t.to_array(), j.to_array())
    assert t.accumulate() == j.accumulate()


@pytest.mark.parametrize("num_bits", [8, 16, 24, 64, 96, 256])
def test_bsequence_ccodes_and_ops(num_bits):
    ta, tb = BSequence.create_ccodes(num_bits)
    ja, jb = JB.create_ccodes(num_bits)
    _same(ta, ja)
    _same(tb, jb)
    assert ta.correlate(tb) == ja.correlate(jb)
    _same(ta.add(tb), ja.add(jb))
    _same(ta.mul(tb), ja.mul(jb))
    for _ in range(5):
        ta.circshift()
        ja.circshift()
        _same(ta, ja)
        assert ta.correlate(tb) == ja.correlate(jb)
    assert [ta.index(i) for i in range(num_bits)] == [ja.index(i) for i in range(num_bits)]


@pytest.mark.parametrize("num_bits", [1, 5, 31, 32, 33, 70])
def test_bsequence_push_init_and_errors(num_bits):
    rng = np.random.default_rng(num_bits)
    data = bytes(rng.integers(0, 256, (num_bits + 7) // 8, dtype=np.uint8))
    t, j = BSequence(num_bits), JB(num_bits)
    t.init(data)
    j.init(data)
    _same(t, j)
    for b in rng.integers(0, 2, 45):
        t.push(int(b))
        j.push(int(b))
    _same(t, j)
    t.reset()
    j.reset()
    _same(t, j)
    with pytest.raises(ConfigError):
        t.index(num_bits)
    with pytest.raises(ConfigError):
        t.correlate(BSequence(num_bits + 32))
    with pytest.raises(ConfigError):
        t.add(BSequence(num_bits + 32))


def test_bsequence_from_msequence_and_ccode_errors():
    for m in (3, 5, 8):
        _same(BSequence.from_msequence(MSequence.create_default(m)),
              JB.from_msequence(JM.create_default(m)))
    for bad in (4, 12):
        with pytest.raises(ConfigError):
            BSequence.create_ccodes(bad)


@pytest.fixture
def native():
    if not native_available():
        pytest.skip("no C++ compiler to build native/*.cpp")


@pytest.mark.parametrize("num_bits", [8, 64, 128])
def test_native_bsequence_matches(native, num_bits):
    na, nb = NativeBSequence.create_ccodes(num_bits)
    ja, jb = JNative.create_ccodes(num_bits)
    pa, pb = BSequence.create_ccodes(num_bits)
    for (n, j, p) in ((na, ja, pa), (nb, jb, pb)):
        assert n.get_length() == j.get_length() == p.get_length()
        assert n.accumulate() == j.accumulate() == p.accumulate()
        bits = [n.index(i) for i in range(num_bits)]
        assert bits == [j.index(i) for i in range(num_bits)] == [p.index(i) for i in range(num_bits)]
    assert na.correlate(nb) == ja.correlate(jb) == pa.correlate(pb)
    for (n, j, p) in ((na.add(nb), ja.add(jb), pa.add(pb)), (na.mul(nb), ja.mul(jb), pa.mul(pb))):
        assert n.accumulate() == j.accumulate() == p.accumulate()
    rng = np.random.default_rng(num_bits)
    for b in rng.integers(0, 2, 50):
        for o in (na, ja, pa):
            o.push(int(b))
    na.circshift()
    ja.circshift()
    pa.circshift()
    assert [na.index(i) for i in range(num_bits)] == [ja.index(i) for i in range(num_bits)] == [
        pa.index(i) for i in range(num_bits)]
    data = bytes(rng.integers(0, 256, num_bits // 8, dtype=np.uint8))
    na.init(data)
    pa2 = BSequence(num_bits)
    pa2.init(data)
    assert [na.index(i) for i in range(num_bits)] == [pa2.index(i) for i in range(num_bits)]


def test_native_bsequence_errors(native):
    with pytest.raises(ConfigError):
        NativeBSequence(0)
    with pytest.raises(ConfigError):
        NativeBSequence.create_ccodes(12)
