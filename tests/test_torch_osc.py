"""yagi_tpu_torch's "exact" oscillator against yagi_tpu's.

The u32 phase (int64 in [0, 2^32) in the port) must be bit-exact: phase
constraint, ramp, carried theta and the u32→f32 step. sin/cos may differ by
an ulp between XLA and torch, so mixed samples agree within rtol 1e-5,
atol 1e-6 (the tolerance of yagi_tpu's own ramp test).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.nco import Osc as JOsc
from yagi_tpu.nco import constrain_phase as j_constrain
from yagi_tpu.nco.osc import _sin_cos as j_sin_cos
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.nco import Osc, constrain_phase
from yagi_tpu_torch.nco.osc import PHASE_TO_RAD, _sin_cos

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


_SWEEP = np.concatenate([
    np.linspace(-40.0, 40.0, 4001),
    [0.0, -0.0, np.pi, -np.pi, 2 * np.pi, -2 * np.pi, 1e-9, -1e-9, 1e-30, 3e5, -3e5],
    2 * np.pi * np.array([0.35, 0.25, 0.5, 0.123, 0.05]),
    np.nextafter(np.float32(2 * np.pi), np.float32(0), dtype=np.float32) + np.zeros(1),
]).astype(np.float32)


def test_constrain_phase_bit_exact():
    want = np.asarray(j_constrain(jnp.asarray(_SWEEP))).astype(np.int64)
    got = constrain_phase(torch.from_numpy(_SWEEP))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("freq", [0.0, 0.35, -0.35, 2 * np.pi * 0.123, 3.0, -6.2])
@pytest.mark.parametrize("phase", [0.0, 0.7, -2.5])
def test_phase_ramp_bit_exact(freq, phase):
    j = JOsc.create("exact", batch_shape=(2,)).set_frequency(freq).set_phase(phase)
    t = Osc.create("exact", batch_shape=(2,), device=DEV).set_frequency(freq).set_phase(phase)
    np.testing.assert_array_equal(t.d_theta.numpy(), np.asarray(j.d_theta).astype(np.int64))
    np.testing.assert_array_equal(
        t._phase_ramp(5000).numpy(), np.asarray(j._phase_ramp(5000)).astype(np.int64)
    )


def test_u32_to_f32_bit_exact():
    rng = np.random.default_rng(3)
    u = np.concatenate([
        rng.integers(0, 1 << 32, 20000, dtype=np.uint64),
        [0, 1, (1 << 24) - 1, 1 << 24, (1 << 24) + 1, (1 << 24) + 3, 0x7FFFFFFF,
         0x80000000, 0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFFFF],
    ]).astype(np.uint32)
    want = np.asarray(jnp.asarray(u).astype(jnp.float32) * jnp.float32(PHASE_TO_RAD))
    got = torch.from_numpy(u.astype(np.int64)).to(torch.float32) * PHASE_TO_RAD
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("freq", [0.2, 0.35, -1.1])
def test_mix_block_down_matches(freq):
    rng = np.random.default_rng(11)
    j = JOsc.create("exact", batch_shape=(3,)).set_frequency(freq).set_phase(0.4)
    t = load_state(Osc, _fields(j), device=DEV)
    for n in (100, 1, 513):
        x = _cplx(rng, (3, n))
        yj, j = j.mix_block_down(jnp.asarray(x))
        yt, t = t.mix_block_down(torch.from_numpy(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(t.theta.numpy(), np.asarray(j.theta).astype(np.int64))


def test_mix_block_down_n_matches():
    rng = np.random.default_rng(12)
    j = JOsc.create("exact").set_frequency(0.3)
    t = Osc.create("exact", device=DEV).set_frequency(0.3)
    for n_valid in (0, 37, 400):
        x = _cplx(rng, (2, 400))
        yj, j = j.mix_block_down_n(jnp.asarray(x), jnp.int32(n_valid))
        yt, t = t.mix_block_down_n(torch.from_numpy(x), torch.tensor(n_valid))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
        assert int(t.theta) == int(np.asarray(j.theta))


def test_load_state_keeps_u32_as_int64():
    j = JOsc.create("exact").set_frequency(-0.35).set_phase(-1.0)
    t = load_state(Osc, _fields(j), device=DEV)
    assert t.theta.dtype == torch.int64 and t.d_theta.dtype == torch.int64
    assert int(t.theta) == int(np.asarray(j.theta)) and int(t.d_theta) > (1 << 31)


@pytest.mark.parametrize("mode", ["nco", "vco", "sideways"])
def test_unported_and_unknown_modes_raise(mode):
    """An unknown mode raises; the table modes, which once raised "not
    ported", look up yagi_tpu's sin/cos bit for bit and mix within this
    file's tolerance (the complex product rounds in XLA's order there)."""
    if mode == "sideways":
        with pytest.raises(ConfigError):
            Osc.create(mode, device=DEV)
        return
    x = _cplx(np.random.default_rng(13), (2, 300))
    j = JOsc.create(mode, batch_shape=(2,)).set_frequency(0.61).set_phase(-1.3)
    t = Osc.create(mode, batch_shape=(2,), device=DEV).set_frequency(0.61).set_phase(-1.3)
    for got, want in zip(_sin_cos(t._phase_ramp(300), mode), j_sin_cos(j._phase_ramp(300), mode)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    yj, j = j.mix_block_up(jnp.asarray(x))
    yt, t = t.mix_block_up(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t.theta.numpy(), np.asarray(j.theta).astype(np.int64))
