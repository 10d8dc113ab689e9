"""yagi_tpu_torch's Farrow values (``Resamp(interp="farrow")``, the
interpolating ``MsResamp`` on it) and FirFarrow, AutoCorr and Dds against
yagi_tpu, on the CPU.

yagi_tpu computes the Farrow values in a TPU layout (a periodic grid, 0/1
selection matmuls); the port computes the same function directly. The
schedule is exact (counts, u32 phase, window, ``exact_sched``,
``step_cert``); the values agree within ``FARROW_TOL = 1e-4`` of max |y|
(measured ≤ 2.2e-7), in the exact head and tail zones at block edges too; the
port's Farrow values agree with its own 256-branch PFB path within 0.03 of
max |y| after the filter transient, as tests/test_farrow_resamp.py holds
yagi_tpu's. FirFarrow, AutoCorr and Dds within ``ATOL = 1e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yagi_tpu.filter as jf
from yagi_tpu.filter import _farrow_resamp as jfr
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
import yagi_tpu_torch.filter as tf
from yagi_tpu_torch.filter import _farrow_resamp as tfr

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

ATOL = 1e-5
FARROW_TOL = 1e-4
PFB_TOL = 0.03  # tests/test_farrow_resamp.py
RATE_TX = 2.0663 / 2  # the transmit-side inverse of config[1]'s resampler

# yagi_tpu's block calls, jitted: its eager Farrow path compiles each op anew
# for every block shape (~4× slower here)
_jexec = jax.jit(lambda o, b: o.execute_block(b))
_jexec_cap = jax.jit(lambda o, b, cap: o.execute_block(b, out_capacity=cap), static_argnums=2)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _bandlimited(rng, c, n, band=0.2):
    """Complex noise low-passed to |f| < band (an FFT mask)."""
    X = np.fft.fft(_cplx(rng, (c, n)), axis=-1)
    X[:, np.abs(np.fft.fftfreq(n)) >= band] = 0
    return np.fft.ifft(X, axis=-1).astype(np.complex64)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max()))


def _same_schedule(t, j):
    assert int(t.phase) == int(np.asarray(j.phase))
    assert int(t.step) == int(np.asarray(j.step))
    assert t.exact_sched == j.exact_sched and t.step_cert == j.step_cert
    np.testing.assert_allclose(t.window.numpy(), np.asarray(j.window), rtol=0, atol=ATOL)


def _zones(t, n):
    """The valid emissions of the next n-sample block in the exact head
    and tail zones of the Farrow path: (head, tail) counts."""
    T, _ = tfr.pick_design(min(0.249, round(min(0.42, 1.4 * t.fc), 3) / 2.0))
    d = T // 2 - 1
    lookahead = (T - d) // 2 + 2
    max_n0 = max(0, (t.step_cert - 1) >> 24) + 2
    p0, step = int(t.phase), int(t.step)
    n_m = np.array([(p0 + m * step) >> 24 for m in range(t.out_capacity(n))])
    n_m = n_m[n_m < n]
    return int((n_m <= (T // 2) // 2 + 1).sum()), int((n_m >= n - lookahead - max_n0).sum())


# ------------------------------------------------------------ the host design
@pytest.mark.parametrize("band", [0.175, 0.21, 0.249])
def test_farrow_design_equals_yagi_tpu(band):
    T, K = tfr.pick_design(band)
    assert (T, K) == jfr.pick_design(band)
    np.testing.assert_array_equal(tfr.farrow_coeffs(T, K, band), jfr.farrow_coeffs(T, K, band))
    assert tfr.farrow_design_error_db(T, K, band) == jfr.farrow_design_error_db(T, K, band)
    assert tfr.farrow_design_error_db(T, K, band) < -50.0


# ------------------------------------------------------------ Resamp values
@pytest.mark.parametrize("rate", [1.37, RATE_TX, 0.7153, 0.5, 2.0])
def test_resamp_farrow_matches_yagi_tpu(rate):
    """Carried blocks, one empty (the port alone: yagi_tpu loses its window
    there); the port takes yagi_tpu's state over after the first block. At
    2.0 the static schedule's banded path runs, as in yagi_tpu."""
    rng = np.random.default_rng(30)
    x = _cplx(rng, (2, 512))
    j = jf.Resamp.create(rate, fc=0.3, interp="farrow", batch_shape=(2,))
    t = tf.Resamp.create(rate, fc=0.3, interp="farrow", batch_shape=(2,), device=DEV)
    _same_schedule(t, j)
    worst, pos = 0.0, 0
    for i, n in enumerate((256, 0, 256)):
        blk = x[:, pos : pos + n]
        pos += n
        yt, kt, t = t.execute_block(torch.from_numpy(blk))
        if n == 0:
            assert int(kt) == 0 and not yt.any()
            continue
        yj, kj, j = _jexec(j, jnp.asarray(blk))
        assert int(kt) == int(kj)
        worst = max(worst, _rel(yt, yj))
        _same_schedule(t, j)
        if i == 0:
            t = load_state(tf.Resamp, j, device=DEV)
    assert worst < FARROW_TOL, worst


@pytest.mark.parametrize("rate", [1.37, 0.7153])
def test_farrow_head_and_tail_zones(rate):
    """Block splits whose emissions fall in the exact-dotprod head (n_m near
    the block start) and tail (the window would need later inputs): short
    blocks that are all head and tail between long ones."""
    rng = np.random.default_rng(31)
    x = _cplx(rng, (2, 600))
    j = jf.Resamp.create(rate, interp="farrow", batch_shape=(2,))
    t = tf.Resamp.create(rate, interp="farrow", batch_shape=(2,), device=DEV)
    heads = tails = 0
    pos = 0
    for n in (7, 250, 7, 250, 7):
        h, tl = _zones(t, n)
        heads, tails = heads + h, tails + tl
        blk = x[:, pos : pos + n]
        pos += n
        yj, kj, j = _jexec(j, jnp.asarray(blk))
        yt, kt, t = t.execute_block(torch.from_numpy(blk))
        assert int(kt) == int(kj)
        assert _rel(yt, yj) < FARROW_TOL
        _same_schedule(t, j)
    assert heads > 10 and tails > 10, (heads, tails)


@pytest.mark.parametrize("rate", [1.37, 0.7153])
def test_farrow_within_the_pfb_floor(rate):
    """The port's Farrow values against its own 256-branch PFB gather; and
    a split run against one long block, which differ by as much: emissions
    at a block edge take the exact branch dot (chip_smoke.py's [filters]
    holds its split run so)."""
    rng = np.random.default_rng(32)
    x = _bandlimited(rng, 2, 1024)
    ya, na, _ = tf.Resamp.create(rate, batch_shape=(2,), device=DEV).execute_block(
        torch.from_numpy(x))
    farrow = tf.Resamp.create(rate, interp="farrow", batch_shape=(2,), device=DEV)
    yb, nb, _ = farrow.execute_block(torch.from_numpy(x))
    assert int(na) == int(nb)
    ref, got = ya[:, 64 : int(na)].numpy(), yb[:, 64 : int(nb)].numpy()
    assert np.abs(ref - got).max() < PFB_TOL * np.abs(ref).max()
    parts = []
    for blk in (x[:, :300], x[:, 300:]):
        y, k, farrow = farrow.execute_block(torch.from_numpy(blk))
        parts.append(y[:, : int(k)].numpy())
    split = np.concatenate(parts, axis=-1)
    assert split.shape[-1] == int(nb)
    assert np.abs(split - yb[:, : int(nb)].numpy()).max() < PFB_TOL * np.abs(ref).max()


def test_farrow_step_certificate_follows_yagi_tpu():
    """set_rate with a number keeps the Farrow path; adjust_rate (a rate
    on the device) leaves the step uncertified and runs the PFB gather;
    reset at the nominal step certifies it again."""
    rng = np.random.default_rng(33)
    x = _cplx(rng, (2, 400))
    j = jf.Resamp.create(1.37, interp="farrow", batch_shape=(2,))
    t = tf.Resamp.create(1.37, interp="farrow", batch_shape=(2,), device=DEV)
    ops = (lambda o: o.set_rate(1.2), lambda o: o.adjust_rate(1.05), lambda o: o.set_rate(1.37),
           lambda o: o.reset())
    pos = 0
    for op in ops:
        j, t = op(j), op(t)
        blk = x[:, pos : pos + 100]
        pos += 100
        yj, kj, j = _jexec_cap(j, jnp.asarray(blk), 160)
        yt, kt, t = t.execute_block(torch.from_numpy(blk), out_capacity=160)
        assert int(kt) == int(kj)
        assert _rel(yt, yj) < FARROW_TOL
        _same_schedule(t, j)
    assert t.step_cert == int(np.round((1 << 24) / 1.37))


@pytest.mark.parametrize("rate", [RATE_TX, 3.0])
def test_msresamp_interp_farrow_matches_yagi_tpu(rate):
    rng = np.random.default_rng(34)
    x = _cplx(rng, (2, 400))
    j = jf.MsResamp.create(rate, batch_shape=(2,), arbitrary_interp="farrow")
    t = tf.MsResamp.create(rate, batch_shape=(2,), arbitrary_interp="farrow", device=DEV)
    pos = 0
    for n in (200, 0, 200):
        blk = x[:, pos : pos + n]
        pos += n
        yt, kt, t = t.execute_block(torch.from_numpy(blk))
        if n == 0:
            assert int(kt) == 0
            continue
        yj, kj, j = _jexec(j, jnp.asarray(blk))
        assert int(kt) == int(kj)
        assert _rel(yt, yj) < FARROW_TOL
        _same_schedule(t.arbitrary, j.arbitrary)
    assert t.get_rate() == j.get_rate() and t.get_delay() == j.get_delay()


# ------------------------------------------------------------ FirFarrow, AutoCorr, Dds
def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("mu", [-0.4, 0.0, 0.27])
def test_firfarrow_matches_yagi_tpu(mu):
    rng = np.random.default_rng(35)
    j = jf.FirFarrow.create(batch_shape=(2,)).set_delay(mu)
    t = tf.FirFarrow.create(batch_shape=(2,), device=DEV).set_delay(mu)
    np.testing.assert_allclose(t.coeffs.numpy(), np.asarray(j.coeffs), rtol=0, atol=0)
    np.testing.assert_allclose(t.taps().numpy(), np.asarray(j.taps()), rtol=0, atol=1e-7)
    assert float(t.get_delay()) == float(j.get_delay())
    assert t.groupdelay(0.05) == pytest.approx(j.groupdelay(0.05), abs=1e-4)
    x = _cplx(rng, (2, 300))
    for blk in (x[:, :120], x[:, 120:]):
        yj, j = j.execute_block(jnp.asarray(blk))
        yt, t = t.execute_block(torch.from_numpy(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        np.testing.assert_allclose(t.window.numpy(), np.asarray(j.window), rtol=0, atol=0)
    y0, t0 = t.execute_block(torch.from_numpy(x[:, :0]))
    assert y0.shape == (2, 0) and torch.equal(t0.window, t.window)
    with pytest.raises(ConfigError):
        t.set_delay(0.6)


@pytest.mark.parametrize("w,d", [(8, 3), (1, 0), (16, 1)])
def test_autocorr_matches_yagi_tpu(w, d):
    rng = np.random.default_rng(36)
    j = jf.AutoCorr.create(w, d, batch_shape=(2,))
    t = tf.AutoCorr.create(w, d, batch_shape=(2,), device=DEV)
    x = _cplx(rng, (2, 200))
    for blk in (x[:, :70], x[:, 70:]):
        yj, j = j.execute_block(jnp.asarray(blk))
        yt, t = t.execute_block(torch.from_numpy(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
        t = load_state(tf.AutoCorr, _fields(j), device=DEV)
    y0, t0 = t.execute_block(torch.from_numpy(x[:, :0]))
    assert y0.shape == (2, 0) and torch.equal(t0.hist, t.hist)


@pytest.mark.parametrize("stages,fc", [(2, 0.1), (1, -0.23)])
def test_dds_matches_yagi_tpu(stages, fc):
    rng = np.random.default_rng(37)
    j = jf.Dds.create(stages, fc, batch_shape=(2,))
    t = tf.Dds.create(stages, fc, batch_shape=(2,), device=DEV)
    f = 1 << stages
    x = _cplx(rng, (2, 96 * f))
    decim = jax.jit(lambda o, b: o.decim_execute(b))
    interp = jax.jit(lambda o, b: o.interp_execute(b))
    for blk in (x[:, : 48 * f], x[:, 48 * f :]):
        yj, j = decim(j, jnp.asarray(blk))
        yt, t = t.decim_execute(torch.from_numpy(blk))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        zj, j = interp(j, jnp.asarray(blk[:, :40]))
        zt, t = t.interp_execute(torch.from_numpy(blk[:, :40]))
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=ATOL)
        for a, b in ((t.osc_down, j.osc_down), (t.osc_up, j.osc_up)):
            np.testing.assert_array_equal(a.theta.numpy(), np.asarray(b.theta).astype(np.int64))
    t, j = t.reset(), j.reset()
    assert not t.osc_up.theta.any()
    np.testing.assert_array_equal(t.osc_up.d_theta.numpy(),
                                  np.asarray(j.osc_up.d_theta).astype(np.int64))
