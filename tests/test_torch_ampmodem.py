"""AmpModem of yagi_tpu_torch against yagi_tpu (modem/ampmodem.py).

* modulate: DSB is elementwise and equal bit for bit; SSB runs the same
  Hilbert FIR (taps bit for bit) through the port's banded convolution,
  within 1e-6 (float32, tests/test_ampmodem.py holds splits to 1e-6).
* demodulate: the carrier tracker c[k] = (1−α)·c[k−1] + α·y[k] is yagi_tpu's
  ``associative_scan`` there and ``iir_chunked_apply`` here (on the CPU its
  plain version, the log-depth ``allpole_parallel``): the same recurrence in
  another summation order, so the message agrees within 2e-5 and the carried
  carrier within 1e-5 (tests/test_ampmodem.py's split tolerance is 2e-5).
* A block split [N1, 0, N2] equals one long block within the same
  tolerances, the empty block keeps the state, and the state carried over
  from yagi_tpu (Hilbert filter, delay line, carrier) gives its third block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.modem import AmpModem as JAmp
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.modem import ampmodem as tamp
from yagi_tpu_torch.modem import AmpModem, AmpModemType

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
MOD_TOL = 1e-6
DEM_TOL = 2e-5
CARRIER_TOL = 1e-5
CASES = [(t, s) for t in ("dsb", "usb", "lsb") for s in (False, True)]


def _message(rng, n: int, c: int = 2) -> np.ndarray:
    t = np.arange(n)
    x = 0.6 * np.sin(2 * np.pi * 0.013 * t)[None, :] + 0.1 * rng.standard_normal((c, n))
    return x.astype(np.float32)


def _jdemod(obj, y):
    """yagi_tpu's demodulate, jitted (its eager associative_scan compiles
    every slice shape)."""
    return jax.jit(lambda o, b: o.demodulate(b))(obj, y)


@pytest.mark.parametrize("typ,suppressed", CASES)
def test_modulate_demodulate_match(typ, suppressed):
    rng = np.random.default_rng(3)
    kw = dict(mu=0.5, type=typ, suppressed=suppressed, m=6, carrier_bw=0.02, batch_shape=(2,))
    j, t = JAmp.create(**kw), AmpModem.create(**kw, device=DEV)
    jd, td = j, t
    for n in (256, 256):
        x = _message(rng, n)
        yj, j = j.modulate(jnp.asarray(x))
        yt, t = t.modulate(torch.from_numpy(x))
        assert yt.dtype == torch.complex64
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=MOD_TOL)
        y = np.asarray(yj)
        y = (y + 0.01 * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
             ).astype(np.complex64)
        mj, jd = _jdemod(jd, jnp.asarray(y))
        mt, td = td.demodulate(torch.from_numpy(y))
        assert mt.dtype == torch.float32
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=DEM_TOL)
        np.testing.assert_allclose(td.carrier.numpy(), np.asarray(jd.carrier), rtol=0,
                                   atol=CARRIER_TOL)
    if typ != "dsb":
        np.testing.assert_array_equal(t.hilb.h.numpy(), np.asarray(j.hilb.h))
        np.testing.assert_allclose(t.delay_line.numpy(), np.asarray(j.delay_line), atol=0)


@pytest.mark.parametrize("typ,suppressed", CASES)
def test_split_and_empty_block(typ, suppressed):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_message(rng, 300))
    m0 = AmpModem.create(0.4, typ, suppressed, m=5, batch_shape=(2,), device=DEV)
    y_long, m_long = m0.modulate(x)
    d_long, dm_long = m0.demodulate(y_long)
    m, dm, ys, ds = m0, m0, [], []
    for a, b in ((0, 111), (111, 111), (111, 300)):
        y, m2 = m.modulate(x[:, a:b])
        d, dm2 = dm.demodulate(y)
        if a == b:
            assert y.shape == (2, 0) and d.shape == (2, 0)
            assert torch.equal(dm2.carrier, dm.carrier)
            if typ != "dsb":
                assert torch.equal(m2.delay_line, m.delay_line)
                assert torch.equal(m2.hilb.window, m.hilb.window)
        m, dm = m2, dm2
        ys.append(y)
        ds.append(d)
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), y_long.numpy(), rtol=0, atol=MOD_TOL)
    np.testing.assert_allclose(torch.cat(ds, -1).numpy(), d_long.numpy(), rtol=0, atol=DEM_TOL)
    np.testing.assert_allclose(dm.carrier.numpy(), dm_long.carrier.numpy(), rtol=0,
                               atol=CARRIER_TOL)


@pytest.mark.parametrize("typ", ["dsb", "usb"])
def test_state_carries_from_yagi_tpu(typ):
    rng = np.random.default_rng(5)
    xs = [_message(rng, n) for n in (200, 150, 180)]
    j = JAmp.create(0.5, typ, False, m=4, batch_shape=(2,))
    jd = j
    for x in xs[:2]:
        y, j = j.modulate(jnp.asarray(x))
        _, jd = _jdemod(jd, y)
    t = load_state(AmpModem, j, device=DEV)
    td = load_state(AmpModem, jd, device=DEV)
    assert t.type is AmpModemType(typ) and (t.hilb is None) == (typ == "dsb")
    yj, j = j.modulate(jnp.asarray(xs[2]))
    yt, t = t.modulate(torch.from_numpy(xs[2]))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=MOD_TOL)
    mj, jd = _jdemod(jd, yj)
    mt, td = td.demodulate(torch.from_numpy(np.asarray(yj)))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=DEM_TOL)
    np.testing.assert_allclose(td.carrier.numpy(), np.asarray(jd.carrier), rtol=0,
                               atol=CARRIER_TOL)


def test_carrier_tracker_runs_iir_chunked(monkeypatch):
    """The tracker goes through ``iir_chunked_apply`` (the kernel on the
    card, its plain version here) once per block of an unsuppressed type,
    and never for a suppressed one."""
    calls = []
    real = tamp.iir_chunked_apply

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tamp, "iir_chunked_apply", counting)
    y = torch.ones(3, 2, 64, dtype=torch.complex64)
    AmpModem.create(0.3, "dsb", False, batch_shape=(3, 2), device=DEV).demodulate(y)
    assert calls == [(6, 64)]
    AmpModem.create(0.3, "usb", True, batch_shape=(3, 2), device=DEV).demodulate(y)
    assert calls == [(6, 64)]
    # a bare carrier, as a zero message modulates: no message, the carrier kept
    bare = torch.full((2, 500), 1.0 / 1.3, dtype=torch.complex64)
    m, dm = AmpModem.create(0.3, "dsb", False, carrier_bw=0.1, batch_shape=(2,),
                            device=DEV).demodulate(bare)
    np.testing.assert_allclose(m.numpy()[:, 0], 0.0, atol=1e-5)  # the envelope: at once
    np.testing.assert_allclose(m.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(dm.carrier.numpy(), 1.0 / 1.3, atol=1e-6)


def test_rejects():
    for kw in (dict(mu=0.0), dict(m=0), dict(carrier_bw=0.5), dict(type="vsb")):
        with pytest.raises((ConfigError, ValueError)):
            AmpModem.create(**kw, device=DEV)


def test_fields_match_yagi_tpu():
    j = JAmp.create(0.3, "lsb", True, m=3, batch_shape=(2,))
    t = AmpModem.create(0.3, "lsb", True, m=3, batch_shape=(2,), device=DEV)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert t.delay == j.delay == 6
