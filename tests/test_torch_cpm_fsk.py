"""FSK and the continuous-phase modems (GMSK, CPFSK) of yagi_tpu_torch
against yagi_tpu (modem/fsk.py, modem/cpm.py).

* Fskmod: the u32 phase words and the carried phase equal yagi_tpu's
  exactly; samples exp(jθ) of the same float32 phase within 1e-6. Fskdem:
  symbols exactly (argmax ties to the first index in both), the last
  spectrum within 1e-5 of its largest bin, the frequency error and symbol
  energy within 1e-5 relative.
* GMSK/CPFSK modulators: the pulse taps bit for bit (host design); the
  phase is a float32 cumulative sum whose rounding grows with |θ|, so the
  samples agree within 1e-6 + 64 float32 ulps of the block's largest |θ|
  (tests/test_cpm.py holds block splits to 1e-5 at its small phases).
* Demodulators: decisions exactly for the full-response pulses (square,
  rcos-full, GMSK's binary bits); for partial-response CPFSK (rcos-partial,
  gmsk pulses at more than 1 bit/symbol) the decision statistic carries ISI
  that can sit on a decision edge, so the decisions are equal wherever the
  statistic is more than 1e-3 from an edge.
* Every object: a block split [S1, 0, S2] equals one long block (1e-5,
  decisions exactly), the empty block keeps the state, and the state
  carried over from yagi_tpu after two blocks gives yagi_tpu's third.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.modem import cpm as jcpm
from yagi_tpu.modem import fsk as jfsk
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.modem import cpm as tcpm
from yagi_tpu_torch.modem import fsk as tfsk

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
EPS32 = float(np.finfo(np.float32).eps)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _phase_tol(theta: torch.Tensor) -> float:
    return 1e-6 + 64 * EPS32 * max(1.0, float(theta.abs().max()))


def _call(obj, method: str, x):
    """yagi_tpu's block call, eager: its CPM objects read their taps on the
    host (``np.asarray(self.h)``), which a jit cannot trace."""
    return getattr(obj, method)(x)


# ------------------------------------------------------------------- FSK
# the last two pad the FFT (k_size > k)
FSK_CASES = [(1, 4, 0.25), (2, 8, 0.2), (3, 16, 0.3), (2, 5, 0.2), (1, 3, 0.2)]


@pytest.mark.parametrize("m,k,bw", FSK_CASES)
def test_fsk_matches(m, k, bw):
    rng = np.random.default_rng(m * 10 + k)
    jm = jfsk.Fskmod.create(m, k, bw, batch_shape=(2,))
    tm = tfsk.Fskmod.create(m, k, bw, batch_shape=(2,), device=DEV)
    jd = jfsk.Fskdem.create(m, k, bw, batch_shape=(2,))
    td = tfsk.Fskdem.create(m, k, bw, batch_shape=(2,), device=DEV)
    assert (td.k_size, td.demod_map) == (jd.k_size, tuple(jd.demod_map))
    for s in (60, 35):
        syms = rng.integers(0, 1 << m, (2, s))
        yj, jm = _call(jm, "modulate", jnp.asarray(syms.astype(np.uint32)))
        yt, tm = tm.modulate(torch.from_numpy(syms))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tm.theta.numpy(), np.asarray(jm.theta).astype(np.int64))
        y = np.asarray(yj)
        y = (y + 0.1 * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
             ).astype(np.complex64)
        sj, jd = _call(jd, "demodulate", jnp.asarray(y))
        st, td = td.demodulate(torch.from_numpy(y))
        assert st.dtype == torch.int32
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(st.numpy(), syms)
        spec = np.asarray(jd.last_spectrum)
        np.testing.assert_allclose(td.last_spectrum.numpy(), spec, rtol=0,
                                   atol=1e-5 * spec.max())
    # yagi_tpu's take over a batch gives [B, B]: channel c's value is [c, c]
    fe = np.diagonal(np.asarray(jd.get_frequency_error()))
    np.testing.assert_allclose(td.get_frequency_error().numpy(), fe, rtol=1e-5, atol=1e-6)
    for s_ in range(1 << m):
        np.testing.assert_allclose(td.get_symbol_energy(s_, 1).numpy(),
                                   np.asarray(jd.get_symbol_energy(s_, 1)), rtol=1e-5)


def test_fsk_split_empty_and_state():
    rng = np.random.default_rng(7)
    syms = rng.integers(0, 4, (2, 90))
    tm0 = tfsk.Fskmod.create(2, 8, 0.2, batch_shape=(2,), device=DEV)
    y_long, tm_long = tm0.modulate(torch.from_numpy(syms))
    tm, parts = tm0, []
    for a, b in ((0, 30), (30, 30), (30, 90)):
        y, tm2 = tm.modulate(torch.from_numpy(syms[:, a:b]))
        if a == b:
            assert y.shape == (2, 0) and torch.equal(tm2.theta, tm.theta)
        tm = tm2
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), y_long.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(tm.theta, tm_long.theta)
    td = tfsk.Fskdem.create(2, 8, 0.2, batch_shape=(2,), device=DEV)
    s_empty, td2 = td.demodulate(y_long[:, :5])  # less than a symbol
    assert s_empty.shape == (2, 0) and td2 is td
    # yagi_tpu's state after two blocks → the port's third block
    jm = jfsk.Fskmod.create(2, 8, 0.2, batch_shape=(2,))
    jd = jfsk.Fskdem.create(2, 8, 0.2, batch_shape=(2,))
    for a, b in ((0, 30), (30, 60)):
        y, jm = _call(jm, "modulate", jnp.asarray(syms[:, a:b].astype(np.uint32)))
        _, jd = _call(jd, "demodulate", y)
    tm, td = load_state(tfsk.Fskmod, _fields(jm), DEV), load_state(tfsk.Fskdem, _fields(jd), DEV)
    yj, jm = _call(jm, "modulate", jnp.asarray(syms[:, 60:].astype(np.uint32)))
    yt, tm = tm.modulate(torch.from_numpy(syms[:, 60:]))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.theta.numpy(), np.asarray(jm.theta).astype(np.int64))
    sj, jd = _call(jd, "demodulate", yj)
    st, td = td.demodulate(yt)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(td.s_demod.numpy(), np.asarray(jd.s_demod))


def test_fsk_rejects():
    with pytest.raises(ConfigError):
        tfsk.Fskmod.create(0, 8, 0.2, device=DEV)
    with pytest.raises(ConfigError):
        tfsk.Fskdem.create(2, 1, 0.2, device=DEV)
    with pytest.raises(ConfigError):
        tfsk.Fskdem.create(4, 10, 0.45, device=DEV)  # the demod map is not unique


# ------------------------------------------------------------------ CPM
def _cpm_pair(kind: str, pkg, **kw):
    mod = pkg.GmskMod if kind == "gmsk" else pkg.CpfskMod
    dem = pkg.GmskDem if kind == "gmsk" else pkg.CpfskDem
    return mod, dem


def _edge_margin(td: tcpm.CpfskDem, y: torch.Tensor) -> np.ndarray:
    """Distance of each decision statistic 0.5·(d + M − 1) from the nearest
    rounding edge (a half-integer), as the port's demodulator forms it."""
    f = tcpm._discriminate(td.prev, y)
    z, _ = tcpm._stream_conv(td.window, f, td.p)
    d = z[..., td.offset:: td.k] / float(np.float32(td.gain))
    v = (0.5 * (d + (td.m_size - 1))).double().numpy()
    return np.abs(v - np.floor(v) - 0.5)


CPFSK_CASES = [(ft, bps, h, k) for ft in tcpm.CpfskFilterType.ALL
               for bps, h, k in ((1, 0.5, 4), (2, 0.5, 4), (3, 0.25, 8))]


@pytest.mark.parametrize("ftype,bps,h,k", CPFSK_CASES)
def test_cpfsk_matches(ftype, bps, h, k):
    rng = np.random.default_rng(bps * 31 + k)
    kw = dict(bps=bps, h_index=h, k=k, ftype=ftype, batch_shape=(2,))
    jm, jd = jcpm.CpfskMod.create(**kw), jcpm.CpfskDem.create(**kw)
    tm, td = tcpm.CpfskMod.create(**kw, device=DEV), tcpm.CpfskDem.create(**kw, device=DEV)
    np.testing.assert_array_equal(tm.p.numpy(), np.asarray(jm.p))
    np.testing.assert_array_equal(td.p.numpy(), np.asarray(jd.p))
    assert (td.delay_syms, td.offset, td.gain) == (jd.delay_syms, jd.offset, jd.gain)
    isi = ftype == "rcos-partial" or (ftype == "gmsk" and bps > 1)
    for s in (80, 47):
        syms = rng.integers(0, 1 << bps, (2, s))
        yj, jm = _call(jm, "modulate", jnp.asarray(syms))
        yt, tm = tm.modulate(torch.from_numpy(syms))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=_phase_tol(tm.theta))
        y = torch.from_numpy(np.asarray(yj))
        margin = _edge_margin(td, y)
        sj, jd = _call(jd, "demodulate", yj)
        st, td = td.demodulate(y)
        assert st.dtype == torch.int32
        keep = margin > 1e-3 if isi else np.ones(margin.shape, bool)
        assert keep.mean() > 0.5
        np.testing.assert_array_equal(st.numpy()[keep], np.asarray(sj)[keep])
        np.testing.assert_allclose(td.window.numpy(), np.asarray(jd.window), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,m,bt", [(2, 3, 0.3), (4, 2, 0.5)])
def test_gmsk_matches(k, m, bt):
    rng = np.random.default_rng(k + m)
    jm, jd = jcpm.GmskMod.create(k, m, bt, (2,)), jcpm.GmskDem.create(k, m, bt, (2,))
    tm = tcpm.GmskMod.create(k, m, bt, (2,), device=DEV)
    td = tcpm.GmskDem.create(k, m, bt, (2,), device=DEV)
    np.testing.assert_array_equal(tm.h.numpy(), np.asarray(jm.h))
    np.testing.assert_array_equal(td.h.numpy(), np.asarray(jd.h))
    bits = rng.integers(0, 2, (2, 200)).astype(np.uint8)
    for a, b in ((0, 120), (120, 200)):
        yj, jm = _call(jm, "modulate", jnp.asarray(bits[:, a:b]))
        yt, tm = tm.modulate(torch.from_numpy(bits[:, a:b]))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=_phase_tol(tm.theta))
        bj, jd = _call(jd, "demodulate", yj)
        bt_, td = td.demodulate(torch.from_numpy(np.asarray(yj)))
        assert bt_.dtype == torch.uint8
        np.testing.assert_array_equal(bt_.numpy(), np.asarray(bj))
    # decisions lag the bits by 2m symbols
    y_all, _ = tcpm.GmskMod.create(k, m, bt, (2,), device=DEV).modulate(torch.from_numpy(bits))
    dec, _ = tcpm.GmskDem.create(k, m, bt, (2,), device=DEV).demodulate(y_all)
    np.testing.assert_array_equal(dec.numpy()[:, 2 * m:], bits[:, : 200 - 2 * m])


@pytest.mark.parametrize("kind", ["gmsk", "cpfsk"])
def test_cpm_split_empty_and_state(kind):
    rng = np.random.default_rng(9)
    if kind == "gmsk":
        args, M = dict(k=2, m=3, bt=0.3, batch_shape=(2,)), 2
    else:
        args, M = dict(bps=2, h_index=0.5, k=4, batch_shape=(2,)), 4
    tmod, tdem = _cpm_pair(kind, tcpm)
    jmod, jdem = _cpm_pair(kind, jcpm)
    syms = rng.integers(0, M, (2, 150))
    tm0, td0 = tmod.create(**args, device=DEV), tdem.create(**args, device=DEV)
    y_long, tm_long = tm0.modulate(torch.from_numpy(syms))
    s_long, td_long = td0.demodulate(y_long)
    tm, td, ys, ss = tm0, td0, [], []
    for a, b in ((0, 60), (60, 60), (60, 150)):
        y, tm2 = tm.modulate(torch.from_numpy(syms[:, a:b]))
        s, td2 = td.demodulate(y)
        if a == b:
            assert y.shape == (2, 0) and s.shape == (2, 0)
            assert torch.equal(tm2.theta, tm.theta) and torch.equal(tm2.window, tm.window)
            assert torch.equal(td2.prev, td.prev) and torch.equal(td2.window, td.window)
        tm, td = tm2, td2
        ys.append(y)
        ss.append(s)
    np.testing.assert_allclose(torch.cat(ys, -1).numpy(), y_long.numpy(), rtol=0,
                               atol=_phase_tol(tm.theta))
    assert torch.equal(torch.cat(ss, -1), s_long)
    # yagi_tpu's state after two blocks → the port's third block
    jm, jd = jmod.create(**args), jdem.create(**args)
    for a, b in ((0, 50), (50, 100)):
        y, jm = _call(jm, "modulate", jnp.asarray(syms[:, a:b]))
        _, jd = _call(jd, "demodulate", y)
    tm, td = load_state(tmod, _fields(jm), DEV), load_state(tdem, _fields(jd), DEV)
    yj, jm = _call(jm, "modulate", jnp.asarray(syms[:, 100:]))
    yt, tm = tm.modulate(torch.from_numpy(syms[:, 100:]))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=_phase_tol(tm.theta))
    sj, jd = _call(jd, "demodulate", yj)
    st, td = td.demodulate(torch.from_numpy(np.asarray(yj)))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_cpm_rejects():
    with pytest.raises(ConfigError):
        tcpm.GmskMod.create(k=1, device=DEV)
    with pytest.raises(ConfigError):
        tcpm.GmskDem.create(bt=1.5, device=DEV)
    with pytest.raises(ConfigError):
        tcpm.CpfskMod.create(bps=9, device=DEV)
    with pytest.raises(ConfigError):
        tcpm.CpfskDem.create(ftype="triangle", device=DEV)
