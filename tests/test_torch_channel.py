"""The channel model of yagi_tpu_torch against yagi_tpu (channel/).

yagi_tpu draws its noise from a ``jax.random`` key and the port from a
``torch.Generator``: the draws cannot be equal. So:

* the deterministic part (multipath FIR → carrier offset up-mix) is held to
  yagi_tpu with the noise off (yagi_tpu at 400 dB SNR, noise std 1e-20;
  the port fed a zero draw), within 1e-5 (float32 streams), the carried
  oscillator phase (u32) exactly, over blocks [100, 0, 57, 130] against
  yagi_tpu's run of the non-empty ones;
* the noise is held to its statistics: the power within 2% of noise_std²
  over 2^20 samples, the real and imaginary parts each half of it (2%) and
  uncorrelated (|ρ| < 0.01), the same seed drawing the same noise;
* a draw passed in (``noise``) is scaled by noise_std·√0.5, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.channel import Channel as JChannel
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.channel import Channel
from yagi_tpu_torch.errors import ConfigError

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
TOL = 1e-5
TAPS = [1.0, 0.3j, -0.1 + 0.05j]


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("taps", [None, TAPS])
def test_deterministic_part_matches(taps):
    rng = np.random.default_rng(1)
    j = JChannel.create(400.0, 0.05, 0.3, taps, batch_shape=(2,))
    t = Channel.create(400.0, 0.05, 0.3, taps, batch_shape=(2,), device=DEV)
    assert (t.has_multipath, t.noise_std) == (j.has_multipath, j.noise_std)
    key = jax.random.PRNGKey(0)
    for n in (100, 0, 57, 130):
        x = _cplx(rng, (2, n))
        off = torch.zeros(2, n, dtype=torch.complex64)
        yt, t2 = t.execute(None, torch.from_numpy(x), noise=off)
        if n == 0:
            assert yt.shape == (2, 0) and torch.equal(t2.osc.theta, t.osc.theta)
            assert torch.equal(t2.mp.window, t.mp.window)
        else:
            key, k = jax.random.split(key)
            yj, j = j.execute(k, jnp.asarray(x))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
        t = t2
    np.testing.assert_array_equal(t.osc.theta.numpy(), np.asarray(j.osc.theta).astype(np.int64))
    np.testing.assert_array_equal(t.mp.window.numpy(), np.asarray(j.mp.window))


def test_block_split_equals_one_block():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_cplx(rng, (2, 300)))
    c0 = Channel.create(20.0, -0.2, 1.0, TAPS, batch_shape=(2,), device=DEV)
    noise = c0.draw_noise(torch.Generator().manual_seed(3), (2, 300))
    y_long, c_long = c0.execute(None, x, noise=noise)
    c, ys = c0, []
    for a, b in ((0, 120), (120, 120), (120, 300)):
        y, c = c.execute(None, x[:, a:b], noise=noise[:, a:b])
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), y_long.numpy(), rtol=0, atol=TOL)
    assert torch.equal(c.osc.theta, c_long.osc.theta)


def test_state_carries_from_yagi_tpu():
    rng = np.random.default_rng(4)
    xs = [_cplx(rng, (2, n)) for n in (80, 60, 90)]
    j = JChannel.create(400.0, 0.7, -0.2, TAPS, batch_shape=(2,))
    key = jax.random.PRNGKey(5)
    for x in xs[:2]:
        key, k = jax.random.split(key)
        _, j = j.execute(k, jnp.asarray(x))
    t = load_state(Channel, {f.name: getattr(j, f.name) for f in dataclasses.fields(j)},
                   device=DEV)
    yj, j = j.execute(key, jnp.asarray(xs[2]))
    yt, t = t.execute(None, torch.from_numpy(xs[2]),
                      noise=torch.zeros(xs[2].shape, dtype=torch.complex64))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
    np.testing.assert_array_equal(t.osc.theta.numpy(), np.asarray(j.osc.theta).astype(np.int64))


@pytest.mark.parametrize("snr_db", [10.0, 30.0])
def test_noise_statistics(snr_db):
    n = 1 << 20
    c = Channel.create(snr_db, batch_shape=(1,), device=DEV)
    y, _ = c.execute(torch.Generator().manual_seed(7), torch.zeros(1, n, dtype=torch.complex64))
    p = c.noise_std ** 2
    assert abs(y.abs().square().mean().item() / p - 1) < 0.02
    assert abs(y.real.square().mean().item() / (p / 2) - 1) < 0.02
    assert abs(y.imag.square().mean().item() / (p / 2) - 1) < 0.02
    rho = (y.real * y.imag).mean().item() / (p / 2)
    assert abs(rho) < 0.01
    # the same seed draws the same noise, another does not
    y2, _ = c.execute(torch.Generator().manual_seed(7), torch.zeros(1, n, dtype=torch.complex64))
    y3, _ = c.execute(torch.Generator().manual_seed(8), torch.zeros(1, n, dtype=torch.complex64))
    assert torch.equal(y, y2) and not torch.equal(y, y3)
    # yagi_tpu's own noise meets the same power gate (tests/test_aux.py's SNR test)
    yj, _ = JChannel.create(snr_db).execute(jax.random.key(0), jnp.zeros(1 << 16, jnp.complex64))
    assert abs(float(np.mean(np.abs(np.asarray(yj)) ** 2)) / p - 1) < 0.05


def test_fed_noise_is_scaled_exactly():
    c = Channel.create(6.0, batch_shape=(3,), device=DEV)
    w = c.draw_noise(torch.Generator().manual_seed(1), (3, 50))
    y, _ = c.execute(None, torch.zeros(3, 50, dtype=torch.complex64), noise=w)
    assert torch.equal(y, w * float(np.float32(c.noise_std * np.sqrt(0.5))))


def test_rejects():
    with pytest.raises(ConfigError):
        Channel.create(multipath_taps=[], device=DEV)
