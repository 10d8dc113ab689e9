"""The RLS equalizer and quantization of yagi_tpu_torch against yagi_tpu
(equalization/eqrls.py, quantization/).

* Eqrls: the same P-matrix recursion in yagi_tpu's order of operations;
  torch and XLA round the complex products and sums apart, so the weights
  after 512 QPSK samples agree within 1e-4 relative to their largest
  magnitude and the outputs within 1e-4 absolute (tests/test_equalization.py
  holds a converged equalizer to 1e-5 of the symbols); a block split equals
  one long block within 1e-5.
* quantize_adc: int32 codes equal yagi_tpu's exactly; with the μ-law
  compander first, within one code (a log1p an ulp apart can cross a code
  edge). compress/expand μ-law: within 1e-6 (tests/test_aux.py's
  TestQuantization tolerance); quantize_dac exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yagi_tpu.quantization as jq
from yagi_tpu.equalization import Eqrls as JEqrls
import yagi_tpu_torch.quantization as tq
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.equalization import Eqrls
from yagi_tpu_torch.errors import ConfigError

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
W_RTOL = 1e-4
Y_ATOL = 1e-4


def _qpsk_link(rng, c: int, n: int):
    """QPSK symbols d [c, n] through a 3-tap channel: (x, d), complex64."""
    d = ((2 * rng.integers(0, 2, (c, n)) - 1) + 1j * (2 * rng.integers(0, 2, (c, n)) - 1))
    d = (d / np.sqrt(2)).astype(np.complex64)
    h = np.array([1.0, 0.25 + 0.2j, -0.1j], np.complex64)
    x = np.stack([np.convolve(r, h)[:n] for r in d])
    x = x + 0.01 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64), d


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("p", [3, 7])
def test_train_block_matches(p):
    rng = np.random.default_rng(p)
    x, d = _qpsk_link(rng, 2, 512)
    j = JEqrls.create(p=p, batch_shape=(2,))
    t = Eqrls.create(p=p, batch_shape=(2,), device=DEV)
    yj, j = j.train_block(jnp.asarray(x), jnp.asarray(d))
    yt, t = t.train_block(torch.from_numpy(x), torch.from_numpy(d))
    assert yt.dtype == torch.complex64 and t.w.dtype == torch.complex64
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=Y_ATOL)
    assert _rel(t.w.numpy(), np.asarray(j.w)) <= W_RTOL
    assert _rel(t.P.numpy(), np.asarray(j.P)) <= W_RTOL
    np.testing.assert_array_equal(t.buffer.numpy(), np.asarray(j.buffer))
    np.testing.assert_allclose(t.get_weights().numpy(), np.asarray(j.get_weights()),
                               rtol=0, atol=W_RTOL * np.abs(np.asarray(j.w)).max())


def test_step_primitives_and_initial_taps():
    rng = np.random.default_rng(9)
    h = (rng.standard_normal(5) + 1j * rng.standard_normal(5)).astype(np.complex64)
    j = JEqrls.create(h, batch_shape=(3,)).set_bw(0.95)
    t = Eqrls.create(h, batch_shape=(3,), device=DEV).set_bw(0.95)
    np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w))
    np.testing.assert_array_equal(t.P.numpy(), np.asarray(j.P))
    for _ in range(6):
        v = (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64)
        j, t = j.push(jnp.asarray(v)), t.push(torch.from_numpy(v))
        yj, yt = j.execute(), t.execute()
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
        j, t = j.step(jnp.complex64(1.0), yj), t.step(torch.tensor(1.0 + 0j), yt)
    assert _rel(t.w.numpy(), np.asarray(j.w)) <= W_RTOL
    t = t.reset()
    np.testing.assert_array_equal(t.w.numpy(), np.broadcast_to(h, (3, 5)))
    assert float(t.get_bw()) == np.float32(0.95)
    with pytest.raises(ConfigError):
        Eqrls.create(p=0, device=DEV)
    with pytest.raises(ConfigError):
        t.set_bw(1.5)


def test_block_split_and_empty_block():
    rng = np.random.default_rng(11)
    x, d = _qpsk_link(rng, 2, 300)
    t0 = Eqrls.create(p=5, batch_shape=(2,), device=DEV)
    y_long, t_long = t0.train_block(torch.from_numpy(x), torch.from_numpy(d))
    t, ys = t0, []
    for a, b in ((0, 120), (120, 120), (120, 300)):
        y, t = t.train_block(torch.from_numpy(x[:, a:b]), torch.from_numpy(d[:, a:b]))
        ys.append(y)
    assert ys[1].shape == (2, 0)
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), y_long.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.w.numpy(), t_long.w.numpy(), rtol=0, atol=1e-5)


def test_state_carries_from_yagi_tpu():
    rng = np.random.default_rng(12)
    x, d = _qpsk_link(rng, 2, 360)
    j = JEqrls.create(p=4, batch_shape=(2,))
    for a, b in ((0, 150), (150, 250)):
        _, j = j.train_block(jnp.asarray(x[:, a:b]), jnp.asarray(d[:, a:b]))
    t = load_state(Eqrls, {f.name: getattr(j, f.name) for f in dataclasses.fields(j)},
                   device=DEV)
    yj, j = j.train_block(jnp.asarray(x[:, 250:]), jnp.asarray(d[:, 250:]))
    yt, t = t.train_block(torch.from_numpy(x[:, 250:]), torch.from_numpy(d[:, 250:]))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=Y_ATOL)
    assert _rel(t.w.numpy(), np.asarray(j.w)) <= W_RTOL


# ----------------------------------------------------------- quantization
_X = np.concatenate([
    np.random.default_rng(0).uniform(-1.3, 1.3, 20000),
    [-1.0, -1.0 + 2 ** -11, 0.0, -0.0, 2 ** -11, 1.0 - 2 ** -11, 1.0, 2.0, -2.0],
]).astype(np.float32)


@pytest.mark.parametrize("bits", [1, 2, 8, 12, 16, 24])
def test_quantize_adc_dac_exact(bits):
    want = np.asarray(jq.quantize_adc(jnp.asarray(_X), bits))
    got = tq.quantize_adc(torch.from_numpy(_X), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq.quantize_dac(got, bits).numpy(),
                                  np.asarray(jq.quantize_dac(jnp.asarray(want), bits)))


@pytest.mark.parametrize("mu", [255.0, 87.6, 1.0])
def test_mulaw_matches(mu):
    xc = (_X + 1j * _X[::-1]).astype(np.complex64)
    for x in (_X, xc):
        c_want = np.asarray(jq.compress_mulaw(jnp.asarray(x), mu))
        c_got = tq.compress_mulaw(torch.from_numpy(x), mu)
        assert c_got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(c_got.numpy(), c_want, rtol=0, atol=1e-6)
        e_want = np.asarray(jq.expand_mulaw(jnp.asarray(c_want), mu))
        np.testing.assert_allclose(tq.expand_mulaw(torch.from_numpy(c_want), mu).numpy(), e_want,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("compander", ["none", "mulaw"])
def test_quantizer_object(compander):
    j, t = jq.Quantizer(10, compander), tq.Quantizer(10, compander)
    qj = np.asarray(j.execute_adc(jnp.asarray(_X)))
    qt = t.execute_adc(torch.from_numpy(_X))
    diff = np.abs(qt.numpy().astype(np.int64) - qj)
    if compander == "none":
        assert diff.max() == 0
    else:
        assert diff.max() <= 1
    np.testing.assert_allclose(t.execute_dac(torch.from_numpy(qj)).numpy(),
                               np.asarray(j.execute_dac(jnp.asarray(qj))), rtol=0, atol=1e-6)


def test_quantization_rejects():
    for bad in (0, 25):
        with pytest.raises(ConfigError):
            tq.quantize_adc(torch.zeros(1), bad)
        with pytest.raises(ConfigError):
            tq.Quantizer(bad)
    with pytest.raises(ConfigError):
        tq.Quantizer(8, "alaw")
    with pytest.raises(ConfigError):
        tq.compress_mulaw(torch.zeros(1), 0.0)
