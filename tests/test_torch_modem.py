"""yagi_tpu_torch's linear modem against yagi_tpu's (modem/modem.py).

* Constellation tables, soft-neighbor tables and the differential increment
  tables are built on the host in numpy by the same code: bit-equal for every
  scheme of tests/test_modem.py.
* ``modulate`` of a table scheme is a gather: bit-equal. Differential
  ``modulate`` is a cumulative product of increments; torch and XLA multiply
  complex numbers in their own order, so it is held to 1e-5 over 64 symbols
  (tests/test_modem.py holds a differential block split to 1e-4).
* Hard ``demodulate`` picks the nearest table point: equal symbols on noisy
  points (no distance lies within rounding of a tie at these seeds), first
  index on exact ties; the differential demodulator gives equal symbols.
* ``demodulate_soft`` and ``demodulate_with_stats``: equal symbols, soft
  bits and statistics within 1e-6 (tests/test_torch_modem_l6.py holds them
  over every scheme).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.modem import Modem as JModem
from yagi_tpu.modem import ModulationScheme as JScheme
from yagi_tpu.modem import gray_decode as jgray_decode
from yagi_tpu.modem import gray_encode as jgray_encode
from yagi_tpu.modem.modem import build_constellation as jbuild
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.modem import Modem, ModulationScheme, gray_decode, gray_encode
from yagi_tpu_torch.modem.modem import build_constellation

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

ALL_TABLE_SCHEMES = [  # tests/test_modem.py:29-37
    "psk2", "psk4", "psk8", "psk16", "psk32", "psk64", "psk128", "psk256",
    "ask2", "ask4", "ask8", "ask16", "ask32", "ask64", "ask128", "ask256",
    "qam4", "qam8", "qam16", "qam32", "qam64", "qam128", "qam256",
    "apsk4", "apsk8", "apsk16", "apsk32", "apsk64", "apsk128", "apsk256",
    "bpsk", "qpsk", "ook", "sqam32", "sqam128", "V29",
    "arb16opt", "arb32opt", "arb64opt", "arb128opt", "arb256opt",
    "arb64vt", "arb64ui",
]
DIFFERENTIAL_SCHEMES = [
    "dpsk2", "dpsk4", "dpsk8", "dpsk16", "dpsk32", "dpsk64", "dpsk128", "dpsk256", "pi4dqpsk",
]
DIFF_TOL = 1e-5


@pytest.mark.parametrize("scheme", ALL_TABLE_SCHEMES)
def test_constellation_bit_equal(scheme):
    t = build_constellation(ModulationScheme.from_str(scheme))
    j = jbuild(JScheme.from_str(scheme))
    assert t.dtype == np.complex64
    np.testing.assert_array_equal(t, j)
    tm, jm = Modem.create(scheme, device=DEV), JModem.create(scheme)
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    np.testing.assert_array_equal(tm.soft_neighbors.numpy(), np.asarray(jm.soft_neighbors))
    assert tm.bits_per_symbol == jm.bits_per_symbol


@pytest.mark.parametrize("scheme", DIFFERENTIAL_SCHEMES)
def test_differential_tables_and_modulate(scheme):
    rng = np.random.default_rng(1)
    tm, jm = Modem.create(scheme, batch_shape=(2,), device=DEV), JModem.create(scheme, batch_shape=(2,))
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    assert tm.bits_per_symbol == jm.bits_per_symbol
    syms = rng.integers(0, tm.constellation_size, size=(2, 64)).astype(np.uint32)
    for part in np.split(syms, [20], axis=-1):  # the carried phase too
        yt, tm = tm.modulate(part)
        yj, jm = jm.modulate(jnp.asarray(part))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=DIFF_TOL)
        dphi = np.angle(np.exp(1j * (tm.phi.numpy() - np.asarray(jm.phi))))  # phi wraps at ±π
        np.testing.assert_allclose(dphi, 0.0, rtol=0, atol=DIFF_TOL)
    # the differential demodulator, once "not ported": yagi_tpu's symbols
    # exactly, its carried phase within the same tolerance
    st, tm = tm.demodulate(yt)
    sj, jm = jm.demodulate(jnp.asarray(yt.numpy()))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).astype(np.int64))
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=0, atol=DIFF_TOL)


@pytest.mark.parametrize("scheme", ["psk8", "qam16", "qam64", "apsk32", "sqam128", "V29",
                                    "arb64vt", "bpsk", "ook"])
def test_modulate_demodulate_match(scheme):
    rng = np.random.default_rng(2)
    tm, jm = Modem.create(scheme, batch_shape=(3,), device=DEV), JModem.create(scheme, batch_shape=(3,))
    M = tm.constellation_size
    syms = rng.integers(0, M, size=(3, 200)).astype(np.uint32)
    yt, _ = tm.modulate(syms)
    yj, _ = jm.modulate(jnp.asarray(syms))
    assert yt.dtype == torch.complex64
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    noisy = (yt.numpy() + 0.05 * (rng.standard_normal(yt.shape)
                                  + 1j * rng.standard_normal(yt.shape))).astype(np.complex64)
    st, tm = tm.demodulate(torch.from_numpy(noisy))
    sj, jm = jm.demodulate(jnp.asarray(noisy))
    assert st.dtype == torch.int64
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).astype(np.int64))
    np.testing.assert_array_equal(tm.x_hat.numpy(), np.asarray(jm.x_hat))
    np.testing.assert_array_equal(tm.r.numpy(), np.asarray(jm.r))
    np.testing.assert_allclose(tm.get_demodulator_phase_error().numpy(),
                               np.asarray(jm.get_demodulator_phase_error()), atol=1e-6)
    np.testing.assert_allclose(tm.get_demodulator_evm().numpy(),
                               np.asarray(jm.get_demodulator_evm()), atol=1e-6)


@pytest.mark.parametrize("scheme", ALL_TABLE_SCHEMES)
def test_noise_free_roundtrip(scheme):
    """Every symbol demodulates to itself (tests/test_modem.py:58)."""
    m = Modem.create(scheme, device=DEV)
    syms = torch.arange(m.constellation_size)
    y, m = m.modulate(syms)
    out, _ = m.demodulate(y)
    assert torch.equal(out, syms)


def test_ties_take_the_first_index_and_symbols_clip():
    m = Modem.from_table(np.array([1, 1j, -1, 1], dtype=np.complex64), device=DEV)  # 0 and 3 coincide
    out, _ = m.demodulate(torch.tensor([1.0 + 0j, 0.0 + 0j]))
    assert out.tolist() == [0, 0]
    y, _ = m.modulate(torch.tensor([-3, 7]))
    assert y.tolist() == [1 + 0j, 1 + 0j]


def test_gray_codes_match():
    s = np.arange(1024, dtype=np.uint32)
    np.testing.assert_array_equal(gray_encode(s), jgray_encode(s))
    np.testing.assert_array_equal(gray_decode(s), jgray_decode(s))
    st = torch.arange(1024)
    assert torch.equal(gray_decode(gray_encode(st)), st)
    np.testing.assert_array_equal(gray_encode(st).numpy(), jgray_encode(s).astype(np.int64))


def test_from_table_and_config_errors():
    table = np.exp(2j * np.pi * np.arange(4) / 4).astype(np.complex64)
    m = Modem.from_table(table, device=DEV)
    assert m.bits_per_symbol == 2 and m.get_scheme() is ModulationScheme.ARB
    with pytest.raises(ConfigError):
        Modem.from_table(np.ones(5, dtype=np.complex64), device=DEV)
    with pytest.raises(ConfigError):
        Modem.create("not_a_scheme", device=DEV)
    assert len(list(ModulationScheme)) >= 52
    for s in ModulationScheme:
        assert ModulationScheme.from_str(s.value) is s


@pytest.mark.parametrize("call", [
    lambda m, x: m.demodulate_soft(x),
    lambda m, x: m.demodulate_with_stats(x),
])
def test_unported_entry_points_raise(call):
    """The entry points that once raised "not ported" give yagi_tpu's
    symbols exactly and its soft bits and statistics within 1e-6."""
    x = np.random.default_rng(5).standard_normal((2, 64)).astype(np.float32)
    x = (x + 1j * x[::-1]).astype(np.complex64) * np.float32(0.7)
    tm, jm = Modem.create("qam16", batch_shape=(2,), device=DEV), JModem.create("qam16",
                                                                                 batch_shape=(2,))
    got = call(tm, torch.from_numpy(x))
    want = call(jm, jnp.asarray(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:-1], want[1:-1]):
        np.testing.assert_allclose(g.numpy().astype(np.complex128),
                                   np.asarray(w).astype(np.complex128), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[-1].x_hat.numpy(), np.asarray(want[-1].x_hat))


def test_state_loads_from_yagi_tpu():
    jm = JModem.create("qam16", batch_shape=(2,))
    _, jm = jm.demodulate(jnp.asarray(np.full((2, 3), 0.3 + 0.1j, np.complex64)))
    tm = load_state(Modem, jm, device=DEV)
    assert tm.scheme is ModulationScheme.QAM16 and tm.rand_state.dtype == torch.int64
    np.testing.assert_array_equal(tm.x_hat.numpy(), np.asarray(jm.x_hat))
    tm = tm.reset()
    assert torch.equal(tm.r, torch.ones(2, dtype=torch.complex64))
