"""yagi_tpu_torch's FirFilter and Resamp against yagi_tpu's and the golden
vectors.

Integer schedules (output counts, resampler phase, oscillator theta,
exact_sched bookkeeping) must be exact; sample values agree within atol 1e-5
(float32 sums in another order; the golden vectors keep the reference's own
2e-3).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.filter import FirFilter as JFir
from yagi_tpu.filter import Resamp as JResamp
from yagi_tpu.nco import Osc as JOsc
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.filter import FirFilter, Resamp
from yagi_tpu_torch.nco import Osc

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "firfilt.npz")
ATOL = 1e-5
GOLDEN_TOL = 2e-3  # tests/test_firfilt.py


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _torch_dtype(np_dtype):
    return torch.complex64 if np.iscomplexobj(np.zeros(0, np_dtype)) else torch.float32


@pytest.mark.parametrize("variant", ["RRRF", "CRCF", "CCCF"])
@pytest.mark.parametrize("case", ["H4X8", "H7X16", "H13X32", "H23X64"])
def test_firfilt_golden(variant, case):
    g = np.load(_GOLDEN)
    h = g[f"FIRFILT_{variant}_DATA_{case}_H"]
    x = g[f"FIRFILT_{variant}_DATA_{case}_X"]
    y_want = g[f"FIRFILT_{variant}_DATA_{case}_Y"]
    f = FirFilter.create(h, dtype=_torch_dtype(x.dtype), device=DEV)
    y, _ = f.execute_block(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_want, atol=GOLDEN_TOL)


def test_firfilt_matches_yagi_tpu_across_blocks():
    """config[0]'s FIR, streamed in uneven blocks; the port takes over the
    yagi_tpu state mid-stream through load_state."""
    rng = np.random.default_rng(1)
    x = _cplx(rng, (3, 1200))
    j = JFir.create_kaiser(64, 0.2, 60.0, 0.0, batch_shape=(3,), dtype=jnp.complex64)
    j = j.set_scale(0.4)
    t = FirFilter.create_kaiser(64, 0.2, 60.0, 0.0, batch_shape=(3,), dtype=torch.complex64, device=DEV)
    t = t.set_scale(0.4)
    for i, blk in enumerate(np.split(x, [400, 401], axis=-1)):
        yj, j = j.execute_block(jnp.asarray(blk))
        yt, t = t.execute_block(torch.from_numpy(blk))
        assert yt.dtype == torch.complex64
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))
        if i == 0:
            t = load_state(FirFilter, _fields(j), device=DEV)


def test_firfilt_rejects_empty():
    with pytest.raises(ConfigError):
        FirFilter.create(np.zeros(0, np.float32), device=DEV)


def _resamp_pair(rate):
    j = JResamp.create(rate, batch_shape=(3,))
    t = Resamp.create(rate, batch_shape=(3,), device=DEV)
    np.testing.assert_array_equal(t.branches.numpy(), np.asarray(j.branches))
    assert int(t.step) == int(np.asarray(j.step)) and t.exact_sched == j.exact_sched
    return j, t


def _check_resamp_state(t, j):
    assert int(t.phase) == int(np.asarray(j.phase))
    assert t.exact_sched == j.exact_sched
    np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))


# 2.0 takes the static banded path (P = 2 | 2^24); 1.7 the general u32 path
@pytest.mark.parametrize("rate", [2.0, 1.7])
def test_resamp_mix_down_matches(rate):
    rng = np.random.default_rng(5)
    x = _cplx(rng, (3, 1200))
    j, t = _resamp_pair(rate)
    jo = JOsc.create("exact", batch_shape=(3,)).set_frequency(0.2)
    to = Osc.create("exact", batch_shape=(3,), device=DEV).set_frequency(0.2)
    for blk in np.split(x, [400, 401], axis=-1):
        yj, kj, j, jo = j.execute_block_mix_down(jnp.asarray(blk), jo)
        yt, kt, t, to = t.execute_block_mix_down(torch.from_numpy(blk), to)
        assert int(kt) == int(np.asarray(kj))
        assert yt.shape == yj.shape
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        _check_resamp_state(t, j)
        np.testing.assert_array_equal(to.theta.numpy(), np.asarray(jo.theta).astype(np.int64))


@pytest.mark.parametrize("rate", [2.0, 1.7, 0.5])
def test_resamp_execute_block_matches(rate):
    rng = np.random.default_rng(6)
    x = _cplx(rng, (3, 1200))
    j, t = _resamp_pair(rate)
    for blk in np.split(x, [400, 401, 800], axis=-1):
        yj, kj, j = j.execute_block(jnp.asarray(blk))
        yt, kt, t = t.execute_block(torch.from_numpy(blk))
        assert int(kt) == int(np.asarray(kj))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        _check_resamp_state(t, j)


def test_resamp_u32_path_from_nonzero_phase():
    """A state carried over mid-stream (nonzero phase, schedule certificate
    cleared) continues exactly as yagi_tpu does."""
    rng = np.random.default_rng(7)
    x = _cplx(rng, (3, 900))
    j = JResamp.create(1.7, batch_shape=(3,))
    _, _, j = j.execute_block(jnp.asarray(x[:, :333]))
    t = load_state(Resamp, _fields(j), device=DEV)
    assert int(t.phase) != 0 and t.exact_sched is None
    for blk in np.split(x[:, 333:], [1, 290], axis=-1):
        yj, kj, j = j.execute_block(jnp.asarray(blk))
        yt, kt, t = t.execute_block(torch.from_numpy(blk))
        assert int(kt) == int(np.asarray(kj))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        _check_resamp_state(t, j)


@pytest.mark.parametrize(
    "kw", [dict(rate=0.0), dict(rate=1.0, m=0), dict(rate=1.0, fc=0.7), dict(rate=300.0),
           dict(rate=1.0, npfb=1 << 17), dict(rate=1.0, interp="linear")]
)
def test_resamp_rejects(kw):
    with pytest.raises(ConfigError):
        Resamp.create(**kw, device=DEV)
