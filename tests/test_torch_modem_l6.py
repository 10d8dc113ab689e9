"""The rest of the linear modem of yagi_tpu_torch against yagi_tpu
(modem/modem.py): soft demodulation, ``demodulate_with_stats`` and the
differential demodulators (DPSK, π/4-DQPSK) with their carried state.

* Hard decisions: equal symbols for every scheme on noisy points (no
  distance or phase difference lies within rounding of a decision edge at
  these seeds).
* Soft bits: the LLR signs (above, at or below the 127 erasure value) are
  equal; the byte values within 1 (a distance an ulp apart can cross a
  rounding edge of the 0..255 scale), both for the rounding default and for
  ``compat=True``'s truncation.
* ``demodulate_with_stats``: x̂, the phase error and the EVM within 1e-5
  (float32 streams); x̂ of a table scheme exactly (a gather).
* Differential state: the carried phase within 1e-5 (wrapped), r and x̂
  within 1e-5; blocks split [40, 0, 1, 87] equal one block of 128 in
  symbols, and an empty block keeps the state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.modem import Modem as JModem
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.modem import Modem

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
TOL = 1e-5

TABLE_SCHEMES = [  # tests/test_modem.py:29-37
    "psk2", "psk4", "psk8", "psk16", "psk32", "psk64", "psk128", "psk256",
    "ask2", "ask4", "ask8", "ask16", "ask32", "ask64", "ask128", "ask256",
    "qam4", "qam8", "qam16", "qam32", "qam64", "qam128", "qam256",
    "apsk4", "apsk8", "apsk16", "apsk32", "apsk64", "apsk128", "apsk256",
    "bpsk", "qpsk", "ook", "sqam32", "sqam128", "V29",
    "arb16opt", "arb32opt", "arb64opt", "arb128opt", "arb256opt",
    "arb64vt", "arb64ui",
]
DIFF_SCHEMES = ["dpsk2", "dpsk4", "dpsk8", "dpsk16", "dpsk32", "dpsk64", "dpsk128", "dpsk256",
                "pi4dqpsk"]


def _noisy(scheme: str, seed: int, n: int = 200, sigma: float = 0.03):
    """(modulated samples + noise [2, n] complex64, the symbols)."""
    rng = np.random.default_rng(seed)
    jm = JModem.create(scheme, batch_shape=(2,))
    syms = rng.integers(0, jm.constellation_size, (2, n)).astype(np.uint32)
    y, _ = jm.modulate(jnp.asarray(syms))
    y = np.asarray(y)
    y = y + sigma * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return y.astype(np.complex64), syms


def _wrapped(a, b) -> np.ndarray:
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b, np.float64)))))


def _check_soft(got, want):
    g, w = got.numpy().astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.dtype == torch.uint8 and g.shape == w.shape
    np.testing.assert_array_equal(np.sign(g - 127), np.sign(w - 127))
    assert np.abs(g - w).max() <= 1


@pytest.mark.parametrize("scheme", TABLE_SCHEMES + DIFF_SCHEMES)
def test_demodulate_soft_matches(scheme):
    y, _ = _noisy(scheme, 1, sigma=0.08)
    tm = Modem.create(scheme, batch_shape=(2,), device=DEV)
    jm = JModem.create(scheme, batch_shape=(2,))
    for compat in (False, True):
        st, soft_t, tn = tm.demodulate_soft(torch.from_numpy(y), compat=compat)
        sj, soft_j, jn = jm.demodulate_soft(jnp.asarray(y), compat=compat)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj).astype(np.int64))
        assert soft_t.shape == (2, 200, tm.bits_per_symbol)
        _check_soft(soft_t, soft_j)
        np.testing.assert_allclose(tn.x_hat.numpy(), np.asarray(jn.x_hat), rtol=0, atol=TOL)


@pytest.mark.parametrize("scheme", TABLE_SCHEMES + DIFF_SCHEMES)
def test_demodulate_with_stats_matches(scheme):
    y, _ = _noisy(scheme, 2)
    tm = Modem.create(scheme, batch_shape=(2,), device=DEV)
    jm = JModem.create(scheme, batch_shape=(2,))
    got = tm.demodulate_with_stats(torch.from_numpy(y))
    want = jm.demodulate_with_stats(jnp.asarray(y))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    if scheme in DIFF_SCHEMES:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=TOL)
    else:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    np.testing.assert_allclose(got[4].r.numpy(), np.asarray(want[4].r), rtol=0, atol=0)
    np.testing.assert_allclose(got[4].x_hat.numpy(), np.asarray(want[4].x_hat), rtol=0, atol=TOL)


@pytest.mark.parametrize("scheme", DIFF_SCHEMES)
def test_differential_roundtrip_split_and_empty(scheme):
    """Noise-free: the port's own modulator → demodulator returns the
    symbols (the first one against the initial phase); blocks [40, 0, 1,
    87] give one block's symbols, the empty block keeps the state."""
    rng = np.random.default_rng(3)
    tm = Modem.create(scheme, batch_shape=(2,), device=DEV)
    syms = torch.from_numpy(rng.integers(0, tm.constellation_size, (2, 128)))
    y, _ = tm.modulate(syms)
    s_long, d_long = tm.demodulate(y)
    np.testing.assert_array_equal(s_long.numpy(), syms.numpy())
    d, parts = tm, []
    for a, b in ((0, 40), (40, 40), (40, 41), (41, 128)):
        s, d2 = d.demodulate(y[:, a:b])
        if a == b:
            assert s.shape == (2, 0) and d2 is d
        d = d2
        parts.append(s)
    assert torch.equal(torch.cat(parts, -1), s_long)
    # the same angle of the same sample; ATen's vector loop and its scalar
    # tail may round it apart
    assert torch.equal(d.r, d_long.r) and _wrapped(d.phi.numpy(), d_long.phi.numpy()).max() <= TOL


@pytest.mark.parametrize("scheme", ["dpsk4", "dpsk16", "pi4dqpsk", "qam16"])
def test_state_carries_from_yagi_tpu(scheme):
    """yagi_tpu demodulates two blocks, the port loads its state (phi, r,
    x̂) and demodulates the third: yagi_tpu's third block's symbols."""
    y, _ = _noisy(scheme, 4, n=300)
    jm = JModem.create(scheme, batch_shape=(2,))
    for a, b in ((0, 100), (100, 180)):
        _, jm = jm.demodulate(jnp.asarray(y[:, a:b]))
    tm = load_state(Modem, jm, device=DEV)
    sj, jm = jm.demodulate(jnp.asarray(y[:, 180:]))
    st, tm = tm.demodulate(torch.from_numpy(y[:, 180:]))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).astype(np.int64))
    assert _wrapped(tm.phi.numpy(), jm.phi).max() <= TOL
    np.testing.assert_allclose(tm.x_hat.numpy(), np.asarray(jm.x_hat), rtol=0, atol=TOL)


@pytest.mark.parametrize("scheme", ["qpsk", "qam16", "dpsk8"])
def test_soft_decisions_decode_noise_free(scheme):
    """Noise-free soft bits carry the symbol's own bits (MSB first)."""
    tm = Modem.create(scheme, device=DEV)
    syms = torch.arange(tm.constellation_size).repeat(3)
    y, _ = tm.modulate(syms)
    s, soft, _ = tm.demodulate_soft(y)
    k = torch.arange(tm.bits_per_symbol - 1, -1, -1)
    bits = (s[..., None] >> k) & 1
    if scheme.startswith("dpsk"):
        s = s[1:]  # the first differential symbol is against the initial phase
        soft, bits = soft[1:], bits[1:]
        syms = syms[1:]
    assert torch.equal(s, syms)
    assert torch.equal((soft > 127).to(torch.int64), bits)
