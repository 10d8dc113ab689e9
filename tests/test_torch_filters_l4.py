"""yagi_tpu_torch's streaming filters of reference layer L4 against
yagi_tpu and the golden vectors, on the CPU: the convolution primitives,
FirPfbFilter, FirInterpolationFilter, FirDecimationFilter, FftFilt, Rresamp,
Fdelay, OrdFilt, design_lpc/levinson, the Osc controls and mixers, Resamp2's
block modes, MsResamp2's and MsResamp's controls, and Resamp's controls.

The same numpy-seeded input goes through both packages, in uneven blocks
(one of them empty) with the state carried, and the port takes yagi_tpu's
state over through ``load_state`` mid-stream. Integer schedules and state
(counts, u32 phases, tap indices, ``exact_sched``, ``step_cert``) are exact;
values within ``ATOL = 1e-5`` (float32 sums in another order); OrdFilt bit
for bit; the host design math equal. The golden vectors hold at the
reference's own 2e-3 (tests/test_firfilt.py, tests/test_filters2.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yagi_tpu.filter as jf
from yagi_tpu.design import FirFilterShape as JShape
from yagi_tpu.filter import _conv as jconv
from yagi_tpu.nco import Osc as JOsc
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.design import FirFilterShape as TShape
from yagi_tpu_torch.errors import ConfigError
import yagi_tpu_torch.filter as tf
from yagi_tpu_torch.filter import _conv as tconv
from yagi_tpu_torch.nco import Osc

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

ATOL = 1e-5
GOLDEN_TOL = 2e-3  # tests/test_firfilt.py, tests/test_filters2.py
_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
BLOCKS = (100, 0, 156)  # uneven, one empty


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.metadata.get("static", False):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        elif isinstance(v, tuple):
            for i, e in enumerate(v):
                yield from _leaves(e, f"{prefix}{f.name}.{i}.")
        else:
            yield prefix + f.name, v


def _same_state(t, j):
    """Every field of the port's object equals yagi_tpu's: static fields
    and integer state exact, float state within ATOL of its largest
    magnitude (FftFilt's tail holds unnormalized sums of ~2n·|y|)."""
    jl = dict(_leaves(j))
    for name, tv in _leaves(t):
        jv = jl[name]
        if not isinstance(tv, torch.Tensor):
            assert tv == jv, name
            continue
        want, got = np.asarray(jv), tv.numpy()
        assert got.shape == want.shape, name
        if np.issubdtype(want.dtype, np.inexact):
            tol = ATOL * max(1.0, np.abs(want).max(initial=0))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), name)


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _stream(j, t, x, call, blocks=BLOCKS, take_over=True):
    """Stream x [..., sum(blocks)] through both objects; ``call(obj, blk)``
    returns (outputs..., state). After the first block the port takes over
    yagi_tpu's state. An empty block goes to the port alone: it must give
    no samples (or zeros) and keep its state, and yagi_tpu, which loses its
    window there, runs the non-empty blocks only. yagi_tpu's calls are
    jitted (its eager ops compile anew for every block shape). Returns both
    states."""
    jcall = jax.jit(call)
    pos = 0
    for i, n in enumerate(blocks):
        blk = x[..., pos : pos + n]
        pos += n
        *yt, t = call(t, torch.from_numpy(blk))
        if n == 0:
            assert all(y.numel() == 0 or not y.any() for y in yt)
            _same_state(t, j)
            continue
        *yj, j = jcall(j, jnp.asarray(blk))
        for a, b in zip(yt, yj):
            _close(a, b)
        _same_state(t, j)
        if i == 0 and take_over:
            t = load_state(type(t), _fields(j), device=DEV)
    return j, t


# ------------------------------------------------------------ _conv
@pytest.mark.parametrize("M", [4, 40])  # yagi_tpu: banded form, then its conv form
@pytest.mark.parametrize("kind", ["real", "complex", "complex taps"])
def test_multi_branch_conv_matches_yagi_tpu(M, kind):
    rng = np.random.default_rng(M)
    x = _cplx(rng, (3, 300)) if kind != "real" else rng.standard_normal((3, 300)).astype(
        np.float32)
    br = (_cplx(rng, (M, 9)) if kind == "complex taps"
          else rng.standard_normal((M, 9)).astype(np.float32))
    want = jconv.multi_branch_conv(jnp.asarray(x), jnp.asarray(br))
    _close(tconv.multi_branch_conv(torch.from_numpy(x), torch.from_numpy(br)), want)
    assert tconv.result_dtype(torch.float32, torch.complex64) == torch.complex64


@pytest.mark.parametrize("stride", [2, 3, 7])
@pytest.mark.parametrize("L", [1, 5, 29])
def test_strided_causal_conv_matches_yagi_tpu(stride, L):
    rng = np.random.default_rng(stride * L)
    x, h = _cplx(rng, (2, 300)), rng.standard_normal(L).astype(np.float32)
    want = jconv.causal_conv_valid(jnp.asarray(x), jnp.asarray(h), stride=stride)
    _close(tconv.causal_conv_valid(torch.from_numpy(x), torch.from_numpy(h), stride=stride), want)


# ------------------------------------------------------------ FirPfbFilter
def _pfb_pair(kind):
    kw = dict(batch_shape=(3,))
    if kind == "kaiser":
        return (jf.FirPfbFilter.create_kaiser(8, 4, 0.4, 60.0, **kw),
                tf.FirPfbFilter.create_kaiser(8, 4, 0.4, 60.0, device=DEV, **kw))
    if kind == "rnyquist":
        return (jf.FirPfbFilter.create_rnyquist(JShape.RRCOS, 8, 2, 3, 0.3, **kw),
                tf.FirPfbFilter.create_rnyquist(TShape.RRCOS, 8, 2, 3, 0.3, device=DEV, **kw))
    return (jf.FirPfbFilter.create_drnyquist(JShape.RRCOS, 8, 2, 3, 0.3, **kw),
            tf.FirPfbFilter.create_drnyquist(TShape.RRCOS, 8, 2, 3, 0.3, device=DEV, **kw))


@pytest.mark.parametrize("kind", ["kaiser", "rnyquist", "drnyquist"])
def test_firpfb_matches_yagi_tpu(kind):
    rng = np.random.default_rng(11)
    j, t = _pfb_pair(kind)
    np.testing.assert_array_equal(t.branches.numpy(), np.asarray(j.branches))
    j, t = j.set_scale(0.7), t.set_scale(0.7)
    x = _cplx(rng, (3, sum(BLOCKS)))
    j, t = _stream(j, t, x, lambda o, b: o.execute_all(b))
    j, t = _stream(j, t, x, lambda o, b: o.execute_block(5, b))
    _close(t.execute(torch.tensor(3)), j.execute(jnp.asarray(3)))
    j, t = j.write(jnp.asarray(x[:, :5])), t.write(torch.from_numpy(x[:, :5]))
    j, t = j.push(jnp.asarray(x[:, 7])), t.push(torch.from_numpy(x[:, 7]))
    _same_state(t, j)
    assert float(t.get_scale()) == float(j.get_scale())
    _same_state(t.reset(), j.reset())


def test_firpfb_rejects_bad_config():
    with pytest.raises(ConfigError):
        tf.FirPfbFilter.create(0, np.ones(4), device=DEV)
    with pytest.raises(ConfigError):
        tf.FirPfbFilter.create_kaiser(4, 2, 0.6, 60.0, device=DEV)


# ------------------------------------------------------------ firinterp
def _interp_pair(kind, dtype):
    jd, td = (jnp.complex64, torch.complex64) if dtype == "c" else (jnp.float32, torch.float32)
    jk, tk = dict(batch_shape=(2,), dtype=jd), dict(batch_shape=(2,), dtype=td, device=DEV)
    if kind == "kaiser":
        return (jf.FirInterpolationFilter.create_kaiser(3, 4, 60.0, **jk),
                tf.FirInterpolationFilter.create_kaiser(3, 4, 60.0, **tk))
    if kind == "prototype":
        return (jf.FirInterpolationFilter.create_prototype(JShape.RRCOS, 4, 3, 0.3, 0.2, **jk),
                tf.FirInterpolationFilter.create_prototype(TShape.RRCOS, 4, 3, 0.3, 0.2, **tk))
    if kind == "linear":
        return (jf.FirInterpolationFilter.create_linear(4, **jk),
                tf.FirInterpolationFilter.create_linear(4, **tk))
    return (jf.FirInterpolationFilter.create_window(3, 2, **jk),
            tf.FirInterpolationFilter.create_window(3, 2, **tk))


@pytest.mark.parametrize("dtype", ["c", "r"])
@pytest.mark.parametrize("kind", ["kaiser", "prototype", "linear", "window"])
def test_firinterp_matches_yagi_tpu(kind, dtype):
    rng = np.random.default_rng(12)
    j, t = _interp_pair(kind, dtype)
    j, t = j.set_scale(1.5), t.set_scale(1.5)
    x = _cplx(rng, (2, sum(BLOCKS)))
    if dtype == "r":
        x = x.real.copy()
    j, t = _stream(j, t, x, lambda o, b: o.execute_block(b))
    yj, j = j.execute(jnp.asarray(x[:, 0]))
    yt, t = t.execute(torch.from_numpy(x[:, 0]))
    _close(yt, yj)
    _same_state(t.reset(), j.reset())
    assert float(t.get_scale()) == float(j.get_scale())


# ------------------------------------------------------------ firdecim
@pytest.mark.parametrize("variant", ["RRRF", "CRCF", "CCCF"])
@pytest.mark.parametrize("case,mfac", [("M2H4X20", 2), ("M3H7X30", 3), ("M4H13X40", 4),
                                       ("M5H23X50", 5)])
def test_firdecim_golden(variant, case, mfac):
    g = np.load(os.path.join(_GOLDEN, "firdecim.npz"))
    h = g[f"FIRDECIM_{variant}_DATA_{case}_H"]
    x = g[f"FIRDECIM_{variant}_DATA_{case}_X"]
    y_want = g[f"FIRDECIM_{variant}_DATA_{case}_Y"]
    dt = torch.complex64 if np.iscomplexobj(x) else torch.float32
    d = tf.FirDecimationFilter.create(mfac, h, dtype=dt, device=DEV)
    y, _ = d.execute_block(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_want, atol=GOLDEN_TOL)


@pytest.mark.parametrize("kind", ["kaiser", "prototype"])
def test_firdecim_matches_yagi_tpu(kind):
    rng = np.random.default_rng(13)
    kw = dict(batch_shape=(2,))
    if kind == "kaiser":
        j = jf.FirDecimationFilter.create_kaiser(3, 4, 60.0, **kw)
        t = tf.FirDecimationFilter.create_kaiser(3, 4, 60.0, device=DEV, **kw)
    else:
        j = jf.FirDecimationFilter.create_prototype(JShape.RRCOS, 4, 3, 0.3, **kw)
        t = tf.FirDecimationFilter.create_prototype(TShape.RRCOS, 4, 3, 0.3, device=DEV, **kw)
    j, t = j.set_scale(0.5), t.set_scale(0.5)
    D = t.decim
    x = _cplx(rng, (2, 96 * D))
    j, t = _stream(j, t, x, lambda o, b: o.execute_block(b), blocks=(30 * D, 0, 66 * D))
    yj, j = j.execute(jnp.asarray(x[:, :D]))
    yt, t = t.execute(torch.from_numpy(x[:, :D]))
    _close(yt, yj)
    assert abs(t.freqresp(0.1) - j.freqresp(0.1)) < 1e-6
    with pytest.raises(ConfigError):
        t.execute_block(torch.zeros(2, D + 1, dtype=torch.complex64))


# ------------------------------------------------------------ fftfilt
@pytest.mark.parametrize("variant", ["RRRF", "CRCF", "CCCF"])
@pytest.mark.parametrize("case", ["H4X256", "H7X256", "H13X256", "H23X256"])
def test_fftfilt_golden(variant, case):
    g = np.load(os.path.join(_GOLDEN, "fftfilt.npz"))
    h = g[f"FFTFILT_{variant}_DATA_{case}_H"]
    x = g[f"FFTFILT_{variant}_DATA_{case}_X"]
    y_want = g[f"FFTFILT_{variant}_DATA_{case}_Y"]
    n = 64
    dt = torch.complex64 if np.iscomplexobj(x) else torch.float32
    f = tf.FftFilt.create(h, n, dtype=dt, device=DEV)
    ys = []
    for i in range(len(x) // n):
        y, f = f.execute(torch.from_numpy(x[i * n : (i + 1) * n]))
        ys.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(ys), y_want, atol=GOLDEN_TOL)
    whole, _ = tf.FftFilt.create(h, n, dtype=dt, device=DEV).execute_blocks(torch.from_numpy(x))
    np.testing.assert_allclose(whole.numpy(), y_want, atol=GOLDEN_TOL)


@pytest.mark.parametrize("real", [False, True])
def test_fftfilt_matches_yagi_tpu(real):
    rng = np.random.default_rng(14)
    h = rng.standard_normal(17).astype(np.float32)
    n = 32
    jd, td = (jnp.float32, torch.float32) if real else (jnp.complex64, torch.complex64)
    j = jf.FftFilt.create(h, n, batch_shape=(2,), dtype=jd).set_scale(0.5)
    t = tf.FftFilt.create(h, n, batch_shape=(2,), dtype=td, device=DEV).set_scale(0.5)
    x = _cplx(rng, (2, 6 * n))
    if real:
        x = x.real.copy()
    j, t = _stream(j, t, x[:, : 2 * n], lambda o, b: o.execute(b), blocks=(n, n))
    j, t = _stream(j, t, x[:, 2 * n :], lambda o, b: o.execute_blocks(b),
                   blocks=(3 * n, 0, n), take_over=False)
    assert float(t.get_scale()) == pytest.approx(float(j.get_scale()))
    assert t.get_length() == j.get_length() == 17
    _same_state(t.reset(), j.reset())


# ------------------------------------------------------------ rresamp
@pytest.mark.parametrize("pq", [(3, 2), (2, 5), (1, 40)])  # (1, 40): the gather form
def test_rresamp_matches_yagi_tpu(pq):
    P, Q = pq
    rng = np.random.default_rng(15)
    kw = dict(batch_shape=(2,))
    j = jf.Rresamp.create_kaiser(2 * P, 2 * Q, m=5, **kw)
    t = tf.Rresamp.create_kaiser(2 * P, 2 * Q, m=5, device=DEV, **kw)
    assert (t.get_p(), t.get_q(), t.get_block_len()) == (j.get_p(), j.get_q(), 2)
    assert t.get_rate() == j.get_rate() and t.get_delay() == j.get_delay()
    x = _cplx(rng, (2, 12 * Q))
    j, t = _stream(j, t, x, lambda o, b: o.execute_block(b), blocks=(4 * Q, 0, 8 * Q))
    j, t = j.write(jnp.asarray(x[:, :3])), t.write(torch.from_numpy(x[:, :3]))
    _same_state(t, j)
    with pytest.raises(ConfigError):
        t.execute_block(torch.zeros(2, Q + 1, dtype=torch.complex64))


def test_rresamp_prototype_and_default():
    rng = np.random.default_rng(16)
    x = _cplx(rng, (60,))
    for j, t in ((jf.Rresamp.create_prototype(JShape.RRCOS, 3, 5, 4, 0.3),
                  tf.Rresamp.create_prototype(TShape.RRCOS, 3, 5, 4, 0.3, device=DEV)),
                 (jf.Rresamp.create_default(4, 3), tf.Rresamp.create_default(4, 3, device=DEV))):
        _same_state(t, j)
        q = t.q
        _stream(j, t, x[: 12 * q], lambda o, b: o.execute_block(b), blocks=(6 * q, 6 * q))
        _same_state(t.reset(), j.reset())


# ------------------------------------------------------------ Fdelay, OrdFilt
@pytest.mark.parametrize("delay", [0.0, 3.7, 5.99, 16.0])
def test_fdelay_matches_yagi_tpu(delay):
    rng = np.random.default_rng(17)
    j = jf.Fdelay.create(16, batch_shape=(2,)).set_delay(delay)
    t = tf.Fdelay.create(16, batch_shape=(2,), device=DEV).set_delay(delay)
    _same_state(t, j)
    x = _cplx(rng, (2, sum(BLOCKS)))
    j, t = _stream(j, t, x, lambda o, b: o.execute_block(b))
    delta = 0.3 if delay < 1 else -0.3
    j, t = j.adjust_delay(delta), t.adjust_delay(delta)
    _same_state(t, j)
    assert float(t.get_delay()) == float(j.get_delay())
    j, t = _stream(j, t, x, lambda o, b: o.execute_block(b), take_over=False)
    _same_state(t.reset(), j.reset())


def test_fdelay_rejects_bad_delay():
    f = tf.Fdelay.create(8, device=DEV)
    for d in (-0.1, 8.5):
        with pytest.raises(ConfigError):
            f.set_delay(d)


@pytest.mark.parametrize("n,k", [(5, 2), (4, 0), (7, 6), (1, 0)])
def test_ordfilt_bit_identical(n, k):
    rng = np.random.default_rng(18)
    x = rng.standard_normal((3, sum(BLOCKS))).astype(np.float32)
    x[:, ::7] = x[:, 3::7][:, : x[:, ::7].shape[1]]  # ties
    j = jf.OrdFilt.create(n, k, batch_shape=(3,))
    t = tf.OrdFilt.create(n, k, batch_shape=(3,), device=DEV)
    pos = 0
    for m in BLOCKS:
        yj, j = j.execute_block(jnp.asarray(x[:, pos : pos + m]))
        yt, t = t.execute_block(torch.from_numpy(x[:, pos : pos + m]))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(t.buf.numpy(), np.asarray(j.buf))
        pos += m
    med_j = jf.OrdFilt.create_medfilt(2).execute_block(jnp.asarray(x[0]))[0]
    med_t = tf.OrdFilt.create_medfilt(2, device=DEV).execute_block(torch.from_numpy(x[0]))[0]
    np.testing.assert_array_equal(med_t.numpy(), np.asarray(med_j))


@pytest.mark.parametrize("make", [
    lambda mod, **kw: mod.OrdFilt.create_medfilt(3, **kw),
    lambda mod, **kw: mod.OrdFilt.create(7, 1, **kw),
], ids=["medfilt3", "n7k1"])
def test_ordfilt_complex_bit_identical(make):
    """Complex samples: yagi_tpu's jnp.sort orders them by real part, then
    imaginary part; the port's order is the same, outputs and the carried
    buf bit for bit, an empty block between two of 64."""
    rng = np.random.default_rng(3)
    blocks = (64, 0, 64)
    x = _cplx(rng, (2, sum(blocks)))
    x[:, 1::5] = x[:, ::5].real[:, : x[:, 1::5].shape[1]] + 1j * x[:, 1::5].imag  # real ties
    j = make(jf, batch_shape=(2,))
    t = make(tf, batch_shape=(2,), device=DEV)
    pos = 0
    for m in blocks:
        yt, t = t.execute_block(torch.from_numpy(x[:, pos : pos + m]))
        if m:  # yagi_tpu runs the non-empty blocks (its carry is the same)
            yj, j = j.execute_block(jnp.asarray(x[:, pos : pos + m]))
            assert yt.dtype == torch.complex64
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        else:
            assert yt.shape == (2, 0)
        np.testing.assert_array_equal(t.buf.numpy(), np.asarray(j.buf))
        pos += m


@pytest.mark.parametrize("p", [1, 4, 10])
def test_lpc_and_levinson_equal(p):
    rng = np.random.default_rng(19)
    x = np.convolve(rng.standard_normal(200), [1.0, 0.6, -0.3])[:200]
    for a, b in zip(tf.design_lpc(x, p), jf.design_lpc(x, p)):
        np.testing.assert_array_equal(a, b)
    r = np.array([np.sum(x[lag:] * x[: 200 - lag]) for lag in range(p + 1)])
    for a, b in zip(tf.levinson(r, p), jf.levinson(r, p)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ConfigError):
        tf.levinson(np.ones(300), 257)


# ------------------------------------------------------------ Osc
def test_osc_controls_and_mixers_match_yagi_tpu():
    rng = np.random.default_rng(20)
    j = JOsc.create("exact", batch_shape=(2,)).set_frequency(0.3).set_phase(2.0)
    t = Osc.create("exact", batch_shape=(2,), device=DEV).set_frequency(0.3).set_phase(2.0)

    def same(a, b):
        np.testing.assert_array_equal(a.theta.numpy(), np.asarray(b.theta).astype(np.int64))
        np.testing.assert_array_equal(a.d_theta.numpy(), np.asarray(b.d_theta).astype(np.int64))

    for op in (lambda o: o.adjust_frequency(-1.1), lambda o: o.adjust_phase(5.5),
               lambda o: o.step(), lambda o: o.adjust_frequency(4.0)):
        j, t = op(j), op(t)
        same(t, j)
        _close(t.get_phase(), j.get_phase())
        _close(t.get_frequency(), j.get_frequency())
        for name in ("sin", "cos", "cexp"):
            _close(getattr(t, name)(), getattr(j, name)())
        for a, b in zip(t.sin_cos(), j.sin_cos()):
            _close(a, b)
    x = _cplx(rng, (2, 77))
    _close(t.mix_up(torch.from_numpy(x[:, 0])), j.mix_up(jnp.asarray(x[:, 0])))
    _close(t.mix_down(torch.from_numpy(x[:, 0])), j.mix_down(jnp.asarray(x[:, 0])))
    for blk in (x, x[:, :0]):
        yj, j = j.mix_block_up(jnp.asarray(blk))
        yt, t = t.mix_block_up(torch.from_numpy(blk))
        _close(yt, yj)
        same(t, j)
    yj, j = j.mix_block_up_n(jnp.asarray(x), 40)
    yt, t = t.mix_block_up_n(torch.from_numpy(x), torch.tensor(40))
    _close(yt, yj)
    same(t, j)
    same(t.reset(), j.reset())


# ------------------------------------------------------------ Resamp2, MsResamp2
def _r2_pair(f0=0.0, dtype="c"):
    jd, td = (jnp.complex64, torch.complex64) if dtype == "c" else (jnp.float32, torch.float32)
    return (jf.Resamp2.create(5, f0, 60.0, batch_shape=(2,), dtype=jd),
            tf.Resamp2.create(5, f0, 60.0, batch_shape=(2,), dtype=td, device=DEV))


@pytest.mark.parametrize("f0", [0.0, 0.2])
@pytest.mark.parametrize("mode", ["decim", "interp", "analyzer", "synthesizer", "filter"])
def test_resamp2_block_modes_match_yagi_tpu(mode, f0):
    rng = np.random.default_rng(21)
    j, t = _r2_pair(f0)
    assert t.get_delay() == j.get_delay() == 9
    j, t = j.set_scale(0.8), t.set_scale(0.8)
    assert complex(t.get_scale()) == complex(np.asarray(j.get_scale()))
    x = _cplx(rng, (2, 2 * sum(BLOCKS)))
    blocks = tuple(2 * n for n in BLOCKS)
    if mode == "synthesizer":
        def call(o, b):
            return o.synthesizer_execute_block(b[..., 0::2], b[..., 1::2])
    else:
        name = {"decim": "decim_execute_block", "interp": "interp_execute_block",
                "analyzer": "analyzer_execute_block", "filter": "filter_execute_block"}[mode]

        def call(o, b):
            return getattr(o, name)(b)
    blocks = blocks if mode != "filter" else (200, 312)  # the filter pair needs samples
    _stream(j, t, x[:, : sum(blocks)], call, blocks=blocks)
    _same_state(t.reset(), j.reset())


@pytest.mark.parametrize("interp,stages", [(True, 2), (False, 2), (True, 0)])
def test_msresamp2_matches_yagi_tpu(interp, stages):
    rng = np.random.default_rng(22)
    j = jf.MsResamp2.create(interp, stages, batch_shape=(2,))
    t = tf.MsResamp2.create(interp, stages, batch_shape=(2,), device=DEV)
    assert t.get_rate() == j.get_rate() and t.get_delay() == j.get_delay()
    f = 1 if interp else 1 << stages
    x = _cplx(rng, (2, 64 * f))
    _stream(j, t, x, lambda o, b: o.execute_block(b), blocks=(24 * f, 0, 40 * f))
    _same_state(t.reset(), j.reset())


# ------------------------------------------------------------ Resamp, MsResamp controls
def test_resamp_controls_match_yagi_tpu():
    rng = np.random.default_rng(23)
    x = _cplx(rng, (2, 300))

    def run(a, b, cap):
        return lambda o: o.execute_block(
            jnp.asarray(x[:, a:b]) if isinstance(o, jf.Resamp) else torch.from_numpy(x[:, a:b]),
            out_capacity=cap)[2]

    j = jf.Resamp.create_default(2.0, batch_shape=(2,))
    t = tf.Resamp.create_default(2.0, batch_shape=(2,), device=DEV)
    _same_state(t, j)
    assert t.get_delay() == j.get_delay() == 7 and float(t.get_rate()) == float(j.get_rate())
    steps = [
        run(0, 100, 216),
        lambda o: o.set_rate(1.37),  # a host number: certified, exact_sched cleared
        run(100, 300, 288),
        lambda o: o.adjust_rate(1.01),  # on the device: uncertified
        lambda o: o.reset(),  # the step is not the nominal one: nothing comes back
        lambda o: o.set_rate(2.0),
        lambda o: o.reset(),  # back at the nominal step: exact_sched and step_cert return
    ]
    for op in steps:
        j, t = op(j), op(t)
        _same_state(t, j)
    assert t.exact_sched == (2, 1) and t.step_cert == 1 << 23
    yj, kj, j = j.execute(jnp.asarray(x[:, 0]))
    yt, kt, t = t.execute(torch.from_numpy(x[:, 0]))
    _close(yt, yj)
    assert int(kt) == int(kj) == 2
    with pytest.raises(ConfigError):
        t.set_rate(300.0)


@pytest.mark.parametrize("rate", [0.3, 3.0, 1.37])
def test_msresamp_controls_match_yagi_tpu(rate):
    rng = np.random.default_rng(24)
    j = jf.MsResamp.create(rate, batch_shape=(2,))
    t = tf.MsResamp.create(rate, batch_shape=(2,), device=DEV)
    assert t.get_rate() == j.get_rate() and t.get_delay() == j.get_delay()
    x = _cplx(rng, (2, 101))
    yj, kj, j = jax.jit(lambda o, b: o.execute_block(b))(j, jnp.asarray(x))
    yt, kt, t = t.execute_block(torch.from_numpy(x))
    assert int(kt) == int(kj)
    _close(yt, yj)
    _same_state(t.reset(), j.reset())
