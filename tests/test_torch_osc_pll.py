"""The oscillator's table modes and PLL of yagi_tpu_torch against yagi_tpu
(nco/osc.py).

* The tables are float32, built by the same numpy code: equal bit for bit.
  The u32 index arithmetic on the int64-held phase must reproduce yagi_tpu's
  shifts and masks, so sin/cos in modes "nco" and "vco" equal yagi_tpu's
  bit for bit on any phase, the wrap at 2^32 included.
* Mixed samples: within rtol 1e-5, atol 1e-6, the tolerance of
  tests/test_resamp_nco.py::TestOsc (the complex product rounds in XLA's
  order there and torch's here). Carried phases (u32): exact.
* The PLL: fed the same phase-detector values, theta and d_theta after
  every step equal yagi_tpu's exactly (u32), alpha and beta exactly.
  Closed around a tone, the loop locks to its frequency within 1e-3 rad/sample
  (tests/test_resamp_nco.py's accessor tolerance is 1e-4 on a set frequency).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.nco import Osc as JOsc
from yagi_tpu.nco.osc import _nco_table as j_nco_table
from yagi_tpu.nco.osc import _sin_cos as j_sin_cos
from yagi_tpu.nco.osc import _vco_tables as j_vco_tables
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.nco import Osc
from yagi_tpu_torch.nco.osc import _nco_table, _sin_cos, _vco_tables

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
MODES = ["nco", "vco", "exact"]
RTOL, ATOL = 1e-5, 1e-6


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64)


def _j64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_tables_bit_exact():
    np.testing.assert_array_equal(_nco_table(), j_nco_table())
    for got, want in zip(_vco_tables(), j_vco_tables()):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["nco", "vco"])
def test_table_sin_cos_bit_exact(mode):
    rng = np.random.default_rng(21)
    th = np.concatenate([
        rng.integers(0, 1 << 32, 50000, dtype=np.uint64),
        [0, 1, (1 << 21) - 1, 1 << 21, (1 << 22) - 1, 1 << 22, (1 << 30) - 1, 1 << 30,
         (1 << 31) - 1, 1 << 31, 0xFFDFFFFF, 0xFFE00000, 0xFFFFFFFF, 0xBFFFFFFF, 0xC0000000],
    ]).astype(np.uint32)
    got = _sin_cos(torch.from_numpy(th.astype(np.int64)), mode)
    want = j_sin_cos(jnp.asarray(th), mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_single_sample_synthesis(mode):
    j = JOsc.create(mode, batch_shape=(3,)).set_frequency(0.4).set_phase(2.9)
    t = Osc.create(mode, batch_shape=(3,), device=DEV).set_frequency(0.4).set_phase(2.9)
    for _ in range(5):
        j, t = j.step(), t.step()
    for name in ("sin", "cos", "cexp"):
        np.testing.assert_allclose(getattr(t, name)().numpy(), np.asarray(getattr(j, name)()),
                                   rtol=RTOL, atol=ATOL)
    x = _cplx(np.random.default_rng(1), (3,))
    np.testing.assert_allclose(t.mix_up(torch.from_numpy(x)).numpy(), np.asarray(j.mix_up(x)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.mix_down(torch.from_numpy(x)).numpy(),
                               np.asarray(j.mix_down(x)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", ["up", "down"])
def test_block_mix_split_and_empty(mode, direction):
    """Blocks [200, 0, 1, 311] agree with yagi_tpu's run of the non-empty
    ones and with one long block of the port; the empty block keeps the
    phase; the carried phase is exact."""
    rng = np.random.default_rng(2)
    x = _cplx(rng, (2, 512))
    j = JOsc.create(mode, batch_shape=(2,)).set_frequency(-2.2).set_phase(0.5)
    t = Osc.create(mode, batch_shape=(2,), device=DEV).set_frequency(-2.2).set_phase(0.5)
    long_y, long_t = getattr(t, f"mix_block_{direction}")(torch.from_numpy(x))
    outs = []
    for a, b in ((0, 200), (200, 200), (200, 201), (201, 512)):
        yt, t2 = getattr(t, f"mix_block_{direction}")(torch.from_numpy(x[:, a:b]))
        if b == a:
            assert yt.shape == (2, 0) and torch.equal(t2.theta, t.theta)
        else:
            yj, j = getattr(j, f"mix_block_{direction}")(jnp.asarray(x[:, a:b]))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)
        t = t2
        outs.append(yt)
    np.testing.assert_array_equal(_u32(t.theta), _j64(j.theta))
    assert torch.equal(t.theta, long_t.theta)
    # the same products; ATen's vector loop and its scalar tail may round apart
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), long_y.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["nco", "vco"])
def test_block_mix_n(mode):
    rng = np.random.default_rng(3)
    j = JOsc.create(mode).set_frequency(0.3)
    t = Osc.create(mode, device=DEV).set_frequency(0.3)
    for n_valid in (0, 37, 400):
        x = _cplx(rng, (2, 400))
        for d in ("up", "down"):
            yj, j = getattr(j, f"mix_block_{d}_n")(jnp.asarray(x), jnp.int32(n_valid))
            yt, t = getattr(t, f"mix_block_{d}_n")(torch.from_numpy(x), torch.tensor(n_valid))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)
            assert int(t.theta) == int(np.asarray(j.theta))


@pytest.mark.parametrize("mode", MODES)
def test_pll_steps_bit_exact(mode):
    """The same phase-detector values: u32 theta and d_theta exact after
    every step, from the default bandwidth and from a set one."""
    rng = np.random.default_rng(4)
    dphi = rng.uniform(-np.pi, np.pi, (300, 4)).astype(np.float32)
    j = JOsc.create(mode, batch_shape=(4,)).set_frequency(0.1)
    t = Osc.create(mode, batch_shape=(4,), device=DEV).set_frequency(0.1)
    np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha))
    np.testing.assert_array_equal(t.beta.numpy(), np.asarray(j.beta))
    for i, d in enumerate(dphi):
        if i == 150:
            j, t = j.pll_set_bandwidth(0.013), t.pll_set_bandwidth(0.013)
            np.testing.assert_array_equal(t.beta.numpy(), np.asarray(j.beta))
        j = j.pll_step(jnp.asarray(d)).step()
        t = t.pll_step(torch.from_numpy(d)).step()
        np.testing.assert_array_equal(_u32(t.theta), _j64(j.theta))
        np.testing.assert_array_equal(_u32(t.d_theta), _j64(j.d_theta))


def test_pll_locks_per_channel():
    """A loop per channel locks to its own offset tone (closed loop: the
    detector is each package's own, so only the lock is compared)."""
    freqs = np.array([0.05, -0.11, 0.2, 0.013], np.float32)
    n = 1500
    tone = torch.polar(torch.ones(4, n), torch.from_numpy(freqs)[:, None] * torch.arange(n)
                       + 0.7)
    for mode in MODES:
        t = Osc.create(mode, batch_shape=(4,), device=DEV).pll_set_bandwidth(0.02)
        for i in range(n):
            dphi = torch.angle(tone[:, i] * t.cexp().conj())
            t = t.pll_step(dphi).step()
        np.testing.assert_allclose(t.get_frequency().numpy(), freqs, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_state_carries_from_yagi_tpu(mode):
    """yagi_tpu runs two blocks (and a bandwidth change), the port loads its
    state (mode, alpha, beta) and runs the third: equal to yagi_tpu's third."""
    rng = np.random.default_rng(5)
    x = [_cplx(rng, (2, n)) for n in (100, 57, 130)]
    j = JOsc.create(mode, batch_shape=(2,)).set_frequency(1.3).pll_set_bandwidth(0.05)
    for b in x[:2]:
        _, j = j.mix_block_up(jnp.asarray(b))
        j = j.pll_step(jnp.float32(0.01))
    t = load_state(Osc, {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}, device=DEV)
    assert t.mode == mode and float(t.alpha) == float(np.asarray(j.alpha))
    yj, j = j.mix_block_up(jnp.asarray(x[2]))
    yt, t = t.mix_block_up(torch.from_numpy(x[2]))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_u32(t.theta), _j64(j.theta))
    np.testing.assert_array_equal(_u32(t.pll_step(0.2).d_theta),
                                  _j64(j.pll_step(jnp.float32(0.2)).d_theta))


def test_default_mode_is_nco():
    t = Osc.create(device=DEV)
    assert t.mode == JOsc.create().mode == "nco"
    assert t.theta.dtype == torch.int64 and t.alpha.dtype == torch.float32
