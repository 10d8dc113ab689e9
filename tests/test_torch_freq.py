"""yagi_tpu_torch's FM modulator and discriminator against yagi_tpu's.

Freqmod is integer phase arithmetic plus a table lookup, so phase and output
are bit-exact (torch.round and jnp.round both round half to even). Freqdem
is one complex product and an angle per sample; torch and XLA evaluate
atan2 differently by an ulp, so outputs agree within atol 1e-6. torch's
vectorized and scalar atan2 also differ by an ulp, so a sample's value can
depend on where it falls in a block: Freqdem's block split and layout checks
hold to the same atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.modem import Freqdem as JFreqdem
from yagi_tpu.modem import Freqmod as JFreqmod
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.modem import Freqdem, Freqmod

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("kf", [0.05, 0.1, 0.3])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_freqmod_bit_exact(kf, batch):
    rng = np.random.default_rng(int(kf * 100) + len(batch))
    j, t = JFreqmod.create(kf, batch_shape=batch), Freqmod.create(kf, batch_shape=batch, device=DEV)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    for _ in range(3):  # the 16-bit phase carries across blocks
        m = rng.normal(scale=0.7, size=batch + (777,)).astype(np.float32)
        yj, j = j.modulate(jnp.asarray(m))
        yt, t = t.modulate(torch.from_numpy(m))
        assert yt.dtype == torch.complex64
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(t.phase.numpy(), np.asarray(j.phase).astype(np.int64))


def test_freqmod_rounds_half_to_even_as_yagi_tpu():
    """Messages whose increment kf·2^16·m is exactly k + 1/2."""
    kf = 0.125  # kf·2^16 = 8192: m = (k + 0.5)/8192 is exact in float32
    m = ((np.arange(-20, 20) + 0.5) / 8192).astype(np.float32)
    yj, j = JFreqmod.create(kf).modulate(jnp.asarray(m))
    yt, t = Freqmod.create(kf, device=DEV).modulate(torch.from_numpy(m))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert int(t.phase) == int(np.asarray(j.phase))


@pytest.mark.parametrize("kf", [0.1, 0.25])
def test_freqdem_matches_yagi_tpu(kf):
    rng = np.random.default_rng(60)
    j, t = JFreqdem.create(kf, batch_shape=(4,)), Freqdem.create(kf, batch_shape=(4,), device=DEV)
    for _ in range(3):  # r_prime carries across blocks
        r = _cplx(rng, (4, 300))
        mj, j = j.demodulate(jnp.asarray(r))
        mt, t = t.demodulate(torch.from_numpy(r))
        assert mt.dtype == torch.float32
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t.r_prime.numpy(), np.asarray(j.r_prime))


def test_freqdem_takes_a_strided_view():
    """The channelizer hands over the transpose of a step-major matrix."""
    rng = np.random.default_rng(61)
    y = torch.from_numpy(_cplx(rng, (50, 8)))
    m1, d1 = Freqdem.create(0.1, batch_shape=(8,), device=DEV).demodulate(y.T)
    m2, d2 = Freqdem.create(0.1, batch_shape=(8,), device=DEV).demodulate(y.T.contiguous())
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(d1.r_prime.numpy(), d2.r_prime.numpy())


def test_block_split_invariance():
    rng = np.random.default_rng(62)
    msg = rng.normal(scale=0.2, size=300).astype(np.float32)
    s1, _ = Freqmod.create(0.2, device=DEV).modulate(torch.from_numpy(msg))
    r = _cplx(rng, 300)
    d1, _ = Freqdem.create(0.2, device=DEV).demodulate(torch.from_numpy(r))
    mod, dem, s_parts, d_parts = Freqmod.create(0.2, device=DEV), Freqdem.create(0.2, device=DEV), [], []
    for a, b in zip(np.split(msg, [50, 51, 200]), np.split(r, [50, 51, 200])):
        s, mod = mod.modulate(torch.from_numpy(a))
        d, dem = dem.demodulate(torch.from_numpy(b))
        s_parts.append(s)
        d_parts.append(d)
    np.testing.assert_array_equal(s1.numpy(), torch.cat(s_parts).numpy())
    np.testing.assert_allclose(d1.numpy(), torch.cat(d_parts).numpy(), rtol=0, atol=1e-6)


def test_state_carries_over_from_yagi_tpu():
    rng = np.random.default_rng(63)
    jm, jd = JFreqmod.create(0.1, batch_shape=(2,)), JFreqdem.create(0.1, batch_shape=(2,))
    _, jm = jm.modulate(jnp.asarray(rng.normal(size=(2, 100)).astype(np.float32)))
    _, jd = jd.demodulate(jnp.asarray(_cplx(rng, (2, 100))))
    tm, td = load_state(Freqmod, _fields(jm), device=DEV), load_state(Freqdem, _fields(jd), device=DEV)
    assert tm.phase.dtype == torch.int64 and td.r_prime.dtype == torch.complex64
    m = rng.normal(size=(2, 64)).astype(np.float32)
    r = _cplx(rng, (2, 64))
    np.testing.assert_array_equal(tm.modulate(torch.from_numpy(m))[0].numpy(),
                                  np.asarray(jm.modulate(jnp.asarray(m))[0]))
    np.testing.assert_allclose(td.demodulate(torch.from_numpy(r))[0].numpy(),
                               np.asarray(jd.demodulate(jnp.asarray(r))[0]), rtol=0, atol=1e-6)


def test_reset():
    rng = np.random.default_rng(64)
    m = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    r = torch.from_numpy(_cplx(rng, 40))
    mod, dem = Freqmod.create(0.1, device=DEV), Freqdem.create(0.1, device=DEV)
    s0, mod2 = mod.modulate(m)
    d0, dem2 = dem.demodulate(r)
    assert int(mod2.phase) != 0 and complex(dem2.r_prime) != 0
    np.testing.assert_array_equal(mod2.reset().modulate(m)[0].numpy(), s0.numpy())
    np.testing.assert_array_equal(dem2.reset().demodulate(r)[0].numpy(), d0.numpy())


@pytest.mark.parametrize("cls", [Freqmod, Freqdem])
@pytest.mark.parametrize("kf", [0.0, -0.5])
def test_rejects_nonpositive_kf(cls, kf):
    with pytest.raises(ConfigError):
        cls.create(kf, device=DEV)


def test_modulate_demodulate_recovers_a_tone():
    """FM mod → demod returns the message within the 10-bit table's phase
    quantization, 1/(1024·kf) = 0.01 (atol 5e-2 as yagi_tpu's round trip)."""
    kf = 0.1
    i = np.arange(2048)
    msg = (0.4 * np.cos(2 * np.pi * 0.013 * i + 0.3)).astype(np.float32)
    s, _ = Freqmod.create(kf, device=DEV).modulate(torch.from_numpy(msg))
    out, _ = Freqdem.create(kf, device=DEV).demodulate(s)
    np.testing.assert_allclose(out.numpy()[1:], msg[1:], rtol=0, atol=5e-2)
