"""yagi_tpu_torch's Hilbert transforms and IIR resamplers against
yagi_tpu's, on the CPU: IirHilbertFilter (decimating and interpolating, on
the sequential and the parallel route), IirDecimationFilter,
IirInterpolationFilter and FirHilbertFilter.

The IIR ones run the port's recurrence (``iir_scan``'s plain version, or
``iir_chunked``'s once ``parallelize()``d): against yagi_tpu's same route,
max |a − b| / max |a| below 5e-5 on the sequential route (XLA's CPU backend
contracts a·b + c into an FMA, the port rounds every op as its kernel does)
and tests/test_iir_parallel.py's 1e-4 for Butterworth SOS on the parallel
one. The FIR one is a banded matmul against an XLA convolution: 1e-5
absolute. Blocks stream with the state carried, and the state is compared
too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.errors import ConfigError as JConfigError
from yagi_tpu.filter import FirHilbertFilter as JFirHilb
from yagi_tpu.filter import IirDecimationFilter as JDecim
from yagi_tpu.filter import IirHilbertFilter as JIirHilb
from yagi_tpu.filter import IirInterpolationFilter as JInterp
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.filter import (
    FirHilbertFilter,
    IirDecimationFilter,
    IirHilbertFilter,
    IirInterpolationFilter,
)

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

SEQ_TOL = 5e-5  # sequential route vs yagi_tpu's (relative to the peak)
SOS_TOL = 1e-4  # parallel route, Butterworth SOS (tests/test_iir_parallel.py)
FIR_ATOL = 1e-5

_jdecim = jax.jit(lambda f, x: f.decim_execute_block(x))
_jinterp = jax.jit(lambda f, x: f.interp_execute_block(x))
_jblock = jax.jit(lambda f, x: f.execute_block(x))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12))


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        else:
            yield prefix + f.name, v


def _close_state(t, j, tol):
    """Every field: statics equal, tensors of the same shape and dtype within
    ``tol`` of the peak (exact where ``tol`` is 0)."""
    tl, jl = dict(_leaves(t)), dict(_leaves(j))
    assert sorted(tl) == sorted(jl)
    for name, tv in tl.items():
        if not isinstance(tv, torch.Tensor):
            assert tv == jl[name], name
            continue
        jv = np.asarray(jl[name])
        assert tv.shape == jv.shape and tv.numpy().dtype == jv.dtype, name
        if tol == 0 or jv.dtype == np.bool_ or jv.dtype.kind == "i":
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=name)
        elif jv.size:
            assert _rel(jv, tv.numpy()) < tol, name


def _real(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
@pytest.mark.parametrize("direction", ["decim", "interp"])
def test_iir_hilbert_matches_yagi_tpu(direction, parallel):
    """Two blocks (an odd pair count first, so the phase state flips) in 2
    channels, outputs and every state field."""
    rng = np.random.default_rng(50)
    j = JIirHilb.create_default(5, batch_shape=(2,))
    t = IirHilbertFilter.create_default(5, batch_shape=(2,), device=DEV)
    _close_state(t, j, 0)
    if parallel:
        j, t = j.parallelize(), t.parallelize()
    tol = SOS_TOL if parallel else SEQ_TOL
    for n in (33, 40):
        if direction == "decim":
            x = _real(rng, (2, 2 * n))
            yj, j = _jdecim(j, jnp.asarray(x))
            yt, t = t.decim_execute_block(torch.from_numpy(x))
            assert yt.shape == (2, n) and yt.dtype == torch.complex64
        else:
            x = _cplx(rng, (2, n))
            yj, j = _jinterp(j, jnp.asarray(x))
            yt, t = t.interp_execute_block(torch.from_numpy(x))
            assert yt.shape == (2, 2 * n) and yt.dtype == torch.float32
        assert _rel(yj, yt.numpy()) < tol
        _close_state(t, j, tol)
    assert int(t.state) == 1 and t.filt0.parallel == parallel


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
@pytest.mark.parametrize("kind", ["decim", "interp"])
def test_iir_resamplers_match_yagi_tpu(kind, parallel):
    """IirDecimationFilter (M = 4, order 5 Butterworth) and
    IirInterpolationFilter (M = 3, order 5 Chebyshev II) on a complex
    signal, two blocks, state carried."""
    rng = np.random.default_rng(51)
    if kind == "decim":
        j = JDecim.create_default(4, 5, batch_shape=(2,), dtype=jnp.complex64)
        t = IirDecimationFilter.create_default(4, 5, batch_shape=(2,), dtype=torch.complex64,
                                               device=DEV)
        lens, ratio = (64, 40), 1 / 4
    else:
        j = JInterp.create_default(3, 5, batch_shape=(2,), dtype=jnp.complex64)
        t = IirInterpolationFilter.create_default(3, 5, batch_shape=(2,), dtype=torch.complex64,
                                                  device=DEV)
        lens, ratio = (30, 17), 3
    _close_state(t, j, 0)
    if parallel:
        j, t = j.parallelize(), t.parallelize()
    tol = SOS_TOL if parallel else SEQ_TOL
    for n in lens:
        x = _cplx(rng, (2, n))
        yj, j = _jblock(j, jnp.asarray(x))
        yt, t = t.execute_block(torch.from_numpy(x))
        assert yt.shape == (2, int(n * ratio)) and yt.dtype == torch.complex64
        assert _rel(yj, yt.numpy()) < tol
        _close_state(t, j, tol)


def test_iir_hilbert_load_state_and_reset():
    """load_state carries a mid-stream yagi_tpu transformer (both IIRs and
    the phase); both continue alike; reset clears everything."""
    rng = np.random.default_rng(52)
    j = JIirHilb.create_default(7, batch_shape=(3,))
    _, j = _jdecim(j, jnp.asarray(_real(rng, (3, 22))))
    t = load_state(IirHilbertFilter, j, device=DEV)
    _close_state(t, j, 0)
    x = _real(rng, (3, 40))
    yj, _ = _jdecim(j, jnp.asarray(x))
    yt, t = t.decim_execute_block(torch.from_numpy(x))
    assert _rel(yj, yt.numpy()) < SEQ_TOL
    r = t.reset()
    assert not r.filt0.v.any() and not r.filt1.v.any() and int(r.state) == 0


@pytest.mark.parametrize("m", [2, 5, 7])
def test_fir_hilbert_matches_yagi_tpu(m):
    """Taps, then decimation and interpolation over two blocks each (odd
    pair counts, so the sign toggle carries), every state field."""
    rng = np.random.default_rng(53 + m)
    j = JFirHilb.create(m, 60.0, batch_shape=(2,))
    t = FirHilbertFilter.create(m, 60.0, batch_shape=(2,), device=DEV)
    _close_state(t, j, 0)
    assert t.get_delay() == j.get_delay()
    jd, td, ji, ti = j, t, j, t
    for n in (21, 16):
        xr = _real(rng, (2, 2 * n))
        yj, jd = _jdecim(jd, jnp.asarray(xr))
        yt, td = td.decim_execute_block(torch.from_numpy(xr))
        assert yt.dtype == torch.complex64
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=FIR_ATOL, rtol=0)
        xc = _cplx(rng, (2, n))
        zj, ji = _jinterp(ji, jnp.asarray(xc))
        zt, ti = ti.interp_execute_block(torch.from_numpy(xc))
        assert zt.dtype == torch.float32 and zt.shape == (2, 2 * n)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=FIR_ATOL, rtol=0)
    _close_state(td, jd, 0)  # windows hold input samples: exact
    _close_state(ti, ji, 0)
    r = td.reset()
    assert not r.w0.any() and not r.w1.any() and not bool(r.toggle)


def test_fir_hilbert_round_trip():
    """c2r then r2c is the identity at the composite delay 2m − 0.5
    (tests/test_filters2.py's check, on the port)."""
    m, n, f = 5, 400, 0.06
    t = np.arange(n)
    x = torch.from_numpy(np.exp(2j * np.pi * f * t).astype(np.complex64))
    y, _ = FirHilbertFilter.create(m, device=DEV).interp_execute_block(x)
    z, _ = FirHilbertFilter.create(m, device=DEV).decim_execute_block(y)
    want = np.exp(2j * np.pi * f * (t - (2 * m - 0.5)))
    assert np.abs(z.numpy()[30:] - want[30:]).mean() < 0.02


@pytest.mark.parametrize("make", [
    lambda mod, kw: mod["fir"].create(1, **kw),
    lambda mod, kw: mod["iir"].create_default(0, **kw),
    lambda mod, kw: mod["decim"].create_default(1, 5, **kw),
    lambda mod, kw: mod["interp"].create_default(1, 5, **kw),
    lambda mod, kw: mod["fir"].create(4, **kw).decim_execute_block(np.zeros(7, np.float32)),
    lambda mod, kw: mod["iir"].create_default(5, **kw).decim_execute_block(np.zeros(9, np.float32)),
    lambda mod, kw: mod["decim"].create_default(4, 5, **kw).execute_block(np.zeros(10, np.float32)),
])
def test_rejects_what_yagi_tpu_rejects(make):
    with pytest.raises(JConfigError):
        make({"fir": JFirHilb, "iir": JIirHilb, "decim": JDecim, "interp": JInterp}, {})
    with pytest.raises(ConfigError):
        make({"fir": FirHilbertFilter, "iir": IirHilbertFilter, "decim": IirDecimationFilter,
              "interp": IirInterpolationFilter}, {"device": DEV})


def test_create_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: FirHilbertFilter.create(4), lambda: IirHilbertFilter.create_default(5),
                 lambda: IirDecimationFilter.create_default(2, 3),
                 lambda: IirInterpolationFilter.create_default(2, 3)):
        with pytest.raises(DeviceError):
            make()
