"""yagi_tpu_torch's Eqlms against yagi_tpu's (equalization/eqlms.py), on the
CPU, with the cases of tests/test_equalization.py.

Constructors build taps on the host in float64 by the same design code:
``w``, ``h0`` and ``get_weights`` are bit-equal. The training loops differ
from yagi_tpu's XLA scans by ulps (XLA's CPU backend contracts a·b + c into
an FMA and sums the taps in its own order; the port rounds each op), and
LMS carries them along: outputs and weights are held to 1e-4 absolute
(measured ≤ 2e-6 on signals of unit power; the running energy x2_sum, ~13
over 13 taps, drifts by 3.1e-5 over 2000 pushes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.design import FirFilterShape as JShape
from yagi_tpu.equalization import Eqlms as JEqlms
from yagi_tpu.filter import FirFilter, FirInterpolationFilter
from yagi_tpu.modem import Modem as JModem
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.equalization import Eqlms
from yagi_tpu_torch.errors import ConfigError, DeviceError

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _qpsk(seed, n):
    rng = np.random.default_rng(seed)
    d, _ = JModem.create("qpsk").modulate(rng.integers(0, 4, size=n).astype(np.uint32))
    return np.asarray(d)


def _channel(sym, taps):
    return np.convolve(sym, taps)[: len(sym)].astype(np.complex64)


def test_identity_default_passes_through():
    """h_len = 9 identity: y[n] = x[n − 4] (tests/test_equalization.py:25)."""
    t, j = Eqlms.create(h_len=9, device=DEV), JEqlms.create(h_len=9)
    x = np.arange(1, 30, dtype=np.float32).astype(np.complex64)
    yt, yj = [], []
    for xi in x:
        t, j = t.push(torch.tensor(xi)), j.push(xi)
        yt.append(complex(t.execute()))
        yj.append(complex(j.execute()))
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(np.asarray(yt)[8:], x[4:-4], atol=1e-5)
    assert int(t.count) == 29 and t.count.dtype == torch.int32


def test_train_block_matches_yagi_tpu():
    """Supervised QPSK through a dispersive channel, h_len 13, μ = 0.3
    (tests/test_equalization.py:36): outputs, weights and energy against
    yagi_tpu; RMSE < −20 dB after convergence."""
    d = _qpsk(0, 2000)
    x = _channel(d, np.array([1.0, 0.0, -0.25 + 0.15j, 0.1], dtype=np.complex64))
    d_ref = np.roll(d, 13 // 2)
    t, j = Eqlms.create(h_len=13, device=DEV).set_bw(0.3), JEqlms.create(h_len=13).set_bw(0.3)
    yt, t = t.train_block(torch.from_numpy(x), torch.from_numpy(d_ref))
    yj, j = j.train_block(jnp.asarray(x), jnp.asarray(d_ref))
    assert yt.dtype == torch.complex64 and yt.shape == (2000,)
    _close(yt.numpy(), yj)
    _close(t.w.numpy(), j.w)
    _close(t.x2_sum.numpy(), j.x2_sum)
    assert int(t.count) == int(j.count) == 2000
    rmse = np.sqrt(np.mean(np.abs(yt.numpy()[-500:] - d_ref[-500:]) ** 2))
    assert 20 * np.log10(rmse) < -20.0


def test_execute_block_blind_matches_yagi_tpu():
    """Blind constant-modulus equalization, the port batched over three
    channels against yagi_tpu channel by channel (its execute_block takes no
    batch: its per-field select broadcasts the [batch] update flag against
    the [h_len] h0), updating every sample (k = 1) and every second (k = 2)."""
    taps = np.array([1.0, 0.0, 0.2 - 0.1j], dtype=np.complex64)
    x = np.stack([_channel(_qpsk(s, 600), taps) for s in (1, 2, 3)])
    for k in (1, 2):
        t = Eqlms.create(h_len=11, batch_shape=(3,), device=DEV).set_bw(0.1)
        yt, t = t.execute_block(k, torch.from_numpy(x))
        assert yt.shape == (3, 600)
        for c in range(3):
            yj, j = JEqlms.create(h_len=11).set_bw(0.1).execute_block(k, jnp.asarray(x[c]))
            _close(yt[c].numpy(), yj)
            _close(t.w[c].numpy(), j.w)
    assert np.abs(np.abs(yt.numpy()[:, -200:]) - 1.0).mean() < 0.1


def test_decim_execute_and_step_match_yagi_tpu():
    """The reference scenarios' loop (tests/test_equalization.py:163): a
    k = 2 decimating equalizer trained toward known QAM16 points through a
    fixed channel, 300 symbols, the lowpass and identity initializations."""
    k, m, beta, p = 2, 7, 0.3, 7
    rng = np.random.default_rng(17)
    jm = JModem.create("qam16")
    v = np.array(jm.modulate(rng.integers(0, 16, size=300).astype(np.uint32))[0])
    x_i, _ = FirInterpolationFilter.create_prototype(JShape.ARKAISER, k, m, beta,
                                                     dtype=jnp.complex64).execute_block(jnp.asarray(v))
    h = np.array([1.0 + 0j, -0.01j, -0.11 + 0.02j, 0.02 + 0.01j, -0.09 - 0.04j], np.complex64)
    x_c = np.array(FirFilter.create(h, dtype=jnp.complex64).execute_block(x_i)[0])
    step = jax.jit(lambda e, xk, d: (lambda y_e: (y_e[0], y_e[1].step(d, y_e[0])))(
        e.decim_execute(xk, k)))
    for make in (lambda a, **kw: a.create_lowpass(2 * k * p + 1, 0.5 / k, **kw),
                 lambda a, **kw: a.create(h_len=2 * k * p + 1, **kw)):
        t, j = make(Eqlms, device=DEV).set_bw(0.3), make(JEqlms).set_bw(0.3)
        np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w))
        for i in range(m + p, 300):
            xk = x_c[i * k:(i + 1) * k]
            d = v[i - (m + p)]
            yt, t = t.decim_execute(torch.from_numpy(xk), k)
            t = t.step(torch.tensor(d), yt)
            yj, j = step(j, jnp.asarray(xk), jnp.asarray(d))
            _close(complex(yt), complex(yj))
        _close(t.w.numpy(), j.w)
        _close(t.get_weights().numpy(), j.get_weights())


def test_constructors_bit_equal():
    for t, j in ((Eqlms.create_lowpass(21, 0.2, device=DEV), JEqlms.create_lowpass(21, 0.2)),
                 (Eqlms.create_rnyquist("rrcos", 2, 7, 0.3, batch_shape=(2,), device=DEV),
                  JEqlms.create_rnyquist(JShape.RRCOS, 2, 7, 0.3, batch_shape=(2,))),
                 (Eqlms.create(h=np.array([0.5, 1j, -0.25]), batch_shape=(3,), device=DEV),
                  JEqlms.create(h=np.array([0.5, 1j, -0.25]), batch_shape=(3,)))):
        assert t.h_len == j.h_len
        for f in ("h0", "w", "buffer", "x2", "x2_sum", "count", "mu"):
            got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            assert got.shape == want.shape and got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t.get_weights().numpy(), np.asarray(j.get_weights()))
    assert Eqlms.create_rnyquist("rrcos", 2, 7, 0.3, device=DEV).h_len == 2 * 2 * 7 + 1


def test_reset_restores_weights_and_bw():
    eq = Eqlms.create_lowpass(21, 0.2, device=DEV)
    w0 = eq.get_weights()
    assert w0.shape == (21,)
    eq2 = eq.push(torch.tensor(1.0 + 0j)).step(torch.tensor(1.0 + 0j), torch.tensor(0.5 + 0j))
    eq3 = eq2.reset()
    assert torch.equal(eq3.get_weights(), w0) and not eq3.buffer.any() and int(eq3.count) == 0
    assert float(eq.set_bw(0.25).get_bw()) == 0.25


def test_state_round_trip_from_yagi_tpu():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 30)) + 1j * rng.normal(size=(2, 30))).astype(np.complex64)
    dd = (np.sign(rng.normal(size=(2, 30))) + 0j).astype(np.complex64)
    _, j = JEqlms.create(h_len=7, batch_shape=(2,)).set_bw(0.1).train_block(jnp.asarray(x),
                                                                            jnp.asarray(dd))
    t = load_state(Eqlms, j, device=DEV)
    assert t.h_len == 7 and t.count.dtype == torch.int32 and t.w.dtype == torch.complex64
    yt, t = t.train_block(torch.from_numpy(x), torch.from_numpy(dd))
    yj, j = j.train_block(jnp.asarray(x), jnp.asarray(dd))
    _close(yt.numpy(), yj)
    _close(t.w.numpy(), j.w)


@pytest.mark.parametrize("make", [
    lambda: Eqlms.create(device=DEV), lambda: Eqlms.create(h_len=5, device=DEV).set_bw(-1.0),
    lambda: Eqlms.create_rnyquist(None, 1, 7, 0.3, device=DEV),
    lambda: Eqlms.create_rnyquist("rrcos", 2, 0, 0.3, device=DEV),
    lambda: Eqlms.create_rnyquist("rrcos", 2, 7, 1.3, device=DEV),
    lambda: Eqlms.create_rnyquist("rrcos", 2, 7, 0.3, dt=2.0, device=DEV),
    lambda: Eqlms.create_lowpass(0, 0.1, device=DEV), lambda: Eqlms.create_lowpass(7, 0.7, device=DEV),
    lambda: Eqlms.create(h_len=5, device=DEV).execute_block(0, torch.zeros(4, dtype=torch.complex64)),
])
def test_rejects_bad_config(make):
    with pytest.raises(ConfigError):
        make()


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device the factory and load_state build on the card; with
    the card hidden they raise DeviceError rather than fall back to the CPU,
    and device="cpu" still works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        Eqlms.create(h_len=7)
    with pytest.raises(DeviceError):
        load_state(Eqlms, JEqlms.create(h_len=7))
    t = load_state(Eqlms, JEqlms.create(h_len=7), device=DEV)
    assert t.w.device.type == "cpu" and Eqlms.create(h_len=7, device=DEV).w.device.type == "cpu"
