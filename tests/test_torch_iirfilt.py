"""yagi_tpu_torch's IIR family against yagi_tpu's, on the CPU: the design
math (``math/poly.py``, ``design/iir.py``), ``IirFilter`` and
``IirFilterSos`` on both routes, the log-depth ``allpole_parallel``, and the
plain versions and shape gates of the ``iir_scan`` / ``iir_chunked`` kernels.

Tolerances:

* design math is host float64 copied line for line: 1e-12;
* the golden vectors (iir/test_data.rs): ``TOL = 1e-2``, as
  tests/test_iirfilt.py holds yagi_tpu;
* the sequential route against yagi_tpu's sequential route: max |a − b| /
  max |a| below ``SEQ_TOL = 5e-5``. The port rounds every product and sum on
  its own, as ``iir.cu`` does, while XLA's CPU backend contracts a·b + c into
  an FMA, so the states part by ulps that the recurrence carries (measured
  ≤ 1.2e-5 on the order-6 golden cases);
* the parallel route (``iir_chunked``'s plain version) against yagi_tpu's
  parallel route and against the sequential one: tests/test_iir_parallel.py's
  2e-5 (TF, first order included) and 1e-4 (Butterworth and integrator SOS);
  both are the same recurrence in other summation orders;
* a block split: bit for bit on the sequential route, 1e-5 on the parallel
  one (tests/test_iir_parallel.py::test_block_split_invariance).

The CUDA kernels run only on a GPU; chip_smoke.py holds ``iir_scan`` against
its plain version bit for bit there, and ``iir_chunked`` by the tolerances
above.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_util import load
from yagi_tpu.design import iir as jdes
from yagi_tpu.errors import ConfigError as JConfigError
from yagi_tpu.filter import IirFilter as JIir
from yagi_tpu.filter import IirFilterSos as JSos
from yagi_tpu.filter._linrec import allpole_parallel as j_allpole
from yagi_tpu.math import poly as jpoly
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.design import iir as tdes
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.filter import IirFilter, IirFilterSos
from yagi_tpu_torch.filter._linrec import allpole_parallel
from yagi_tpu_torch.kernels import _build
from yagi_tpu_torch.kernels import iir as kiir
from yagi_tpu_torch.math import poly as tpoly

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

TOL = 1e-2  # the golden vectors (tests/test_iirfilt.py)
DES_TOL = 1e-12  # host float64 design math
SEQ_TOL = 5e-5  # sequential route vs yagi_tpu's (FMA contraction on XLA's side)
TF_TOL, SOS_TOL, SPLIT_TOL = 2e-5, 1e-4, 1e-5  # tests/test_iir_parallel.py
# block length wherever yagi_tpu's routes run (each compiles per shape)
N_PAR = 64

# yagi_tpu's block calls, jitted: one compile per filter structure and shape
# instead of one per eager op
_jblock = jax.jit(lambda f, x: f.execute_block(x))
_jallpole = jax.jit(j_allpole)

_DT = {np.dtype(np.float32): torch.float32, np.dtype(np.complex64): torch.complex64}


def _rel(a, b) -> float:
    """max |a − b| / max |a| (tests/test_iir_parallel.py's measure)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12))


def _signal(rng, shape, complex_: bool) -> np.ndarray:
    z = rng.standard_normal(shape)
    if complex_:
        z = z + 1j * rng.standard_normal(shape)
    return z.astype(np.complex64 if complex_ else np.float32)


# ------------------------------------------------------------ golden vectors
@pytest.mark.parametrize("variant", ["RRRF", "CRCF", "CCCF"])
@pytest.mark.parametrize("case", ["H3X64", "H5X64", "H7X64"])
def test_golden_tf(variant, case):
    """tests/test_iirfilt.py's golden cases through the port's sequential
    route (golden at TOL, yagi_tpu at SEQ_TOL) and its parallel route
    (golden at TOL)."""
    g = load("iirfilt")
    b, a, x, y_want = (g[f"IIRFILT_{variant}_DATA_{case}_{k}"] for k in "BAXY")
    f = IirFilter.create(b, a, dtype=_DT[x.dtype], device=DEV)
    y, _ = f.execute_block(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_want, atol=TOL)
    yj, _ = JIir.create(b, a, dtype=x.dtype).execute_block(x)
    assert _rel(yj, y.numpy()) < SEQ_TOL
    yp, _ = f.parallelize().execute_block(torch.from_numpy(x))
    np.testing.assert_allclose(yp.numpy(), y_want, atol=TOL)


def test_golden_split_is_exact():
    """The sequential route over blocks of 10, 1, 29 and 24 samples equals
    one block bit for bit."""
    g = load("iirfilt")
    b, a, x = (g[f"IIRFILT_CCCF_DATA_H5X64_{k}"] for k in "BAX")
    f = IirFilter.create(b, a, dtype=torch.complex64, device=DEV)
    y1, f1 = f.execute_block(torch.from_numpy(x))
    parts = []
    for c in np.split(x, [10, 11, 40]):
        y, f = f.execute_block(torch.from_numpy(c))
        parts.append(y)
    assert torch.equal(torch.cat(parts), y1) and torch.equal(f.v, f1.v)


# -------------------------------------------------------------- design math
_SHAPES = ["BUTTER", "CHEBY1", "CHEBY2", "ELLIP", "BESSEL"]
_BANDS = ["LOWPASS", "HIGHPASS", "BANDPASS", "BANDSTOP"]
_FORMATS = ["TRANSFER_FUNCTION", "SECOND_ORDER_SECTIONS"]


@pytest.mark.parametrize("fmt", _FORMATS)
@pytest.mark.parametrize("band", _BANDS)
@pytest.mark.parametrize("shape", _SHAPES)
def test_iir_design_matches_yagi_tpu(shape, band, fmt):
    for order, fc, f0 in ((3, 0.1, 0.25), (4, 0.2, 0.15)):
        args = (order, fc, f0, 1.0, 60.0)
        bj, aj = jdes.iir_design(jdes.IirFilterShape[shape], jdes.IirBandType[band],
                                 jdes.IirFormat[fmt], *args)
        bt, at = tdes.iir_design(tdes.IirFilterShape[shape], tdes.IirBandType[band],
                                 tdes.IirFormat[fmt], *args)
        assert bt.shape == bj.shape and at.shape == aj.shape
        np.testing.assert_allclose(bt, bj, rtol=DES_TOL, atol=DES_TOL)
        np.testing.assert_allclose(at, aj, rtol=DES_TOL, atol=DES_TOL)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_analog_prototypes_match_yagi_tpu(n):
    cases = [
        ("iir_design_butter_analog", (n,)),
        ("iir_design_cheby1_analog", (n, 0.5)),
        ("iir_design_cheby2_analog", (n, 0.01)),
        ("iir_design_ellip_analog", (n, 0.5, 1000.0)),
        ("iir_design_bessel_analog", (n,)),
    ]
    for name, args in cases:
        for got, want in zip(getattr(tdes, name)(*args), getattr(jdes, name)(*args)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=DES_TOL,
                                       atol=DES_TOL, err_msg=name)


def test_design_stages_match_yagi_tpu():
    """The pipeline's stages one by one: prewarp, bilinear transform, the
    band transforms, TF and SOS realizations."""
    za, pa, ka = jdes.iir_design_ellip_analog(5, 0.5, 1000.0)
    for band in _BANDS:
        mj = jdes.iir_design_freqprewarp(jdes.IirBandType[band], 0.15, 0.2)
        assert tdes.iir_design_freqprewarp(tdes.IirBandType[band], 0.15, 0.2) == pytest.approx(
            mj, rel=DES_TOL)
    m = jdes.iir_design_freqprewarp(jdes.IirBandType.LOWPASS, 0.15, 0.0)
    zj, pj, kj = jdes.iir_design_bilinear_a2d(za, pa, ka, m)
    zt, pt, kt = tdes.iir_design_bilinear_a2d(za, pa, ka, m)
    np.testing.assert_allclose(zt, zj, atol=DES_TOL)
    np.testing.assert_allclose(pt, pj, atol=DES_TOL)
    assert kt == pytest.approx(kj, rel=DES_TOL)
    for got, want in ((tdes.iir_design_lp2hp(zj, pj), jdes.iir_design_lp2hp(zj, pj)),
                      (tdes.iir_design_lp2bp(zj, pj, 0.2), jdes.iir_design_lp2bp(zj, pj, 0.2)),
                      (tdes.iir_design_d2tf(zj, pj, kj), jdes.iir_design_d2tf(zj, pj, kj)),
                      (tdes.iir_design_d2sos(zj, pj, kj), jdes.iir_design_d2sos(zj, pj, kj))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=DES_TOL, atol=DES_TOL)


def test_design_checks_match_yagi_tpu():
    """is_stable, find_conjugate_pairs, group delay and the PLL designs."""
    b, a = jdes.iir_design(jdes.IirFilterShape.BUTTER, jdes.IirBandType.LOWPASS,
                           jdes.IirFormat.TRANSFER_FUNCTION, 6, 0.2, 0.0, 1.0, 60.0)
    for bb, aa in ((b, a), ([1.0], [1.0, -2.5]), ([1.0], [1.0, -0.5, 0.06])):
        assert tdes.iir_design_is_stable(bb, aa) == jdes.iir_design_is_stable(bb, aa)
    z = np.array([10 + 3j, 5 + 0j, -3 + 4j, 10 - 3j, 3 + 0j, -3 - 4j])
    np.testing.assert_array_equal(tdes.find_conjugate_pairs(z), jdes.find_conjugate_pairs(z))
    rng = np.random.default_rng(5)
    r = rng.standard_normal(10) + 1j * rng.standard_normal(10)
    z = np.concatenate([r, r.conj(), rng.standard_normal(3)])
    np.testing.assert_array_equal(tdes.find_conjugate_pairs(z), jdes.find_conjugate_pairs(z))
    for fc in (0.0, 0.02, 0.2, -0.3):
        assert tdes.iir_group_delay(b, a, fc) == pytest.approx(jdes.iir_group_delay(b, a, fc),
                                                               rel=DES_TOL, abs=DES_TOL)
    for name in ("iir_design_pll_active_lag", "iir_design_pll_active_pi"):
        for got, want in zip(getattr(tdes, name)(0.1, 0.7, 1000.0),
                             getattr(jdes, name)(0.1, 0.7, 1000.0)):
            np.testing.assert_array_equal(got, want)


_BAD_DESIGNS = [
    ("iir_design", ("BUTTER", "LOWPASS", "TRANSFER_FUNCTION", 0, 0.2, 0.0, 1.0, 60.0)),
    ("iir_design", ("BUTTER", "LOWPASS", "TRANSFER_FUNCTION", 5, 0.7, 0.0, 1.0, 60.0)),
    ("iir_design", ("BUTTER", "BANDPASS", "SECOND_ORDER_SECTIONS", 5, 0.2, 0.6, 1.0, 60.0)),
    ("iir_design", ("CHEBY1", "LOWPASS", "SECOND_ORDER_SECTIONS", 5, 0.2, 0.0, 0.0, 60.0)),
    ("iir_design", ("CHEBY2", "LOWPASS", "SECOND_ORDER_SECTIONS", 5, 0.2, 0.0, 1.0, -1.0)),
    ("iir_design_pll_active_lag", (-0.1, 0.7, 1000.0)),
    ("iir_design_pll_active_pi", (0.1, -0.7, 1000.0)),
    ("iir_design_pll_active_pi", (0.1, 0.7, 0.0)),
    ("iir_design_is_stable", ([1.0], [1.0])),
    ("iir_group_delay", ([1.0], [1.0, 0.5], 0.7)),
]


@pytest.mark.parametrize("name, args", _BAD_DESIGNS)
def test_design_rejects_what_yagi_tpu_rejects(name, args):
    def resolve(mod):
        enums = (mod.IirFilterShape, mod.IirBandType, mod.IirFormat)
        return [enums[i][v] if name == "iir_design" and i < 3 else v for i, v in enumerate(args)]

    with pytest.raises(JConfigError):
        getattr(jdes, name)(*resolve(jdes))
    with pytest.raises(ConfigError):
        getattr(tdes, name)(*resolve(tdes))


def test_poly_matches_yagi_tpu():
    rng = np.random.default_rng(11)
    p = rng.standard_normal(6)
    r = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    x = np.sort(rng.uniform(-1, 1, 7))
    y = rng.standard_normal(7)
    cases = [
        ("poly_val", (p, 0.37)),
        ("poly_fit", (x, y, 3)),
        ("poly_expandbinomial", (6,)),
        ("poly_expandbinomial_pm", (7, 3)),
        ("poly_expandroots", (r,)),
        ("poly_expandroots2", (r[:3], r[3:] + 1.0)),
        ("poly_mul", (p, p[:3])),
        ("poly_interp_lagrange", (x, y, 0.1)),
        ("poly_fit_lagrange", (x, y)),
        ("poly_fit_lagrange_barycentric", (x,)),
        ("poly_findroots", (p,)),
        ("poly_findroots_durandkerner", (p,)),
    ]
    for name, args in cases:
        got, want = getattr(tpoly, name)(*args), getattr(jpoly, name)(*args)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=DES_TOL, atol=DES_TOL,
                                   err_msg=name)
    w = jpoly.poly_fit_lagrange_barycentric(x)
    assert tpoly.poly_val_lagrange_barycentric(x, y, w, 0.2) == pytest.approx(
        jpoly.poly_val_lagrange_barycentric(x, y, w, 0.2), rel=DES_TOL)


# ------------------------------------------------------------ the filters
def _tf_coefs(rng, order: int, complex_: bool = False):
    """A stable TF filter: poles within 0.6/order of 0, random numerator
    (tests/test_iir_parallel.py's recipe)."""
    b = rng.standard_normal(order + 1) * 0.3
    poles = 0.6 * rng.standard_normal(order) / max(order, 1)
    if complex_:
        b = b + 0.3j * rng.standard_normal(order + 1)
        poles = poles * np.exp(1j * rng.uniform(0, np.pi, order))
    return b, (np.poly(poles) if order else np.array([1.0]))


def _make(kind: str, rng, mod):
    """A filter of ``kind`` from yagi_tpu's (mod = "j") or the port's IirFilter
    (keyword arguments only differ by the device), with 3 channels."""
    cls, kw = (JIir, {}) if mod == "j" else (IirFilter, {"device": DEV})
    kw["batch_shape"] = (3,)
    des = jdes if mod == "j" else tdes
    if kind.startswith("tf"):
        order = int(kind[2:].rstrip("c"))
        b, a = _tf_coefs(np.random.default_rng(order), order, kind.endswith("c"))
        return cls.create(b, a, **kw)
    if kind == "lowpass7":
        return cls.create_lowpass(7, 0.1, **kw)
    if kind == "cheby2_bp":
        return cls.create_prototype(des.IirFilterShape.CHEBY2, des.IirBandType.BANDPASS,
                                    des.IirFormat.SECOND_ORDER_SECTIONS, 3, 0.1, 0.2, 1.0, 40.0,
                                    **kw)
    if kind == "cheby1_tf":
        return cls.create_prototype(des.IirFilterShape.CHEBY1, des.IirBandType.LOWPASS,
                                    des.IirFormat.TRANSFER_FUNCTION, 3, 0.2, 0.0, 1.0, 40.0, **kw)
    if kind == "dc_blocker":
        return cls.create_dc_blocker(0.1, **kw)
    if kind == "pll":
        return cls.create_pll(0.1, 0.7, 10.0, **kw)
    if kind == "integrator":
        return cls.create_integrator(**kw)
    if kind == "differentiator":
        return cls.create_differentiator(**kw)
    raise AssertionError(kind)


_SEQ_KINDS = ["tf1", "tf2", "tf4", "tf3c", "lowpass7", "cheby2_bp", "cheby1_tf", "dc_blocker",
              "pll", "integrator", "differentiator"]


def _dtypes(kind: str, complex_sig: bool):
    if kind.endswith("c"):  # complex coefficients: a complex signal only
        return jnp.complex64, torch.complex64
    return (jnp.complex64, torch.complex64) if complex_sig else (jnp.float32, torch.float32)


def _run_both(j, t, xs):
    """Stream ``xs`` through both; return the outputs and final filters."""
    yj, yt = [], []
    for x in xs:
        y, j = _jblock(j, jnp.asarray(x))
        yj.append(np.asarray(y))
        y, t = t.execute_block(torch.from_numpy(x))
        yt.append(y.numpy())
    return np.concatenate(yj, -1), np.concatenate(yt, -1), j, t


def _with_dtype(f, dtype):
    return f.replace(v=f.v.astype(dtype) if hasattr(f.v, "astype") else f.v.to(dtype))


def _cases(kinds):
    """(kind, complex signal) pairs: real and complex signals, and complex
    coefficients (a kind ending in "c") on a complex signal only."""
    return [(k, c) for k in kinds for c in (False, True) if c or not k.endswith("c")]


@pytest.mark.parametrize("kind, complex_sig", _cases(_SEQ_KINDS))
def test_sequential_route_matches_yagi_tpu(kind, complex_sig):
    """Two blocks of 3 channels with the state carried: outputs and the
    final state against yagi_tpu's sequential route."""
    jd, td = _dtypes(kind, complex_sig)
    rng = np.random.default_rng(20)
    j = _with_dtype(_make(kind, rng, "j"), jd)
    t = _with_dtype(_make(kind, rng, "t"), td)
    xs = [_signal(rng, (3, N_PAR), td.is_complex) for _ in range(2)]
    yj, yt, j, t = _run_both(j, t, xs)
    assert yt.dtype == yj.dtype and yt.shape == yj.shape
    assert _rel(yj, yt) < SEQ_TOL
    assert _rel(np.asarray(j.v), t.v.numpy()) < SEQ_TOL
    assert not t.parallel and t.sos_form == j.sos_form


# order ≤ 2 or SOS (yagi_tpu's _linrec.py note: the companion powers of
# higher-order TF filters carry large transients in fp32)
_PAR_KINDS = ["tf1", "tf2c", "lowpass7", "dc_blocker", "integrator"]


@pytest.mark.parametrize("kind, complex_sig", _cases(_PAR_KINDS))
def test_parallel_route_matches_yagi_tpu(kind, complex_sig):
    """parallelize()d: two blocks against yagi_tpu's parallel route, and the
    first against the port's own sequential route, the state carried."""
    jd, td = _dtypes(kind, complex_sig)
    tol = TF_TOL if kind.startswith(("tf", "dc")) else SOS_TOL
    rng = np.random.default_rng(21)
    j = _with_dtype(_make(kind, rng, "j"), jd).parallelize()
    t = _with_dtype(_make(kind, rng, "t"), td).parallelize()
    xs = [_signal(rng, (3, N_PAR), td.is_complex) for _ in range(2)]
    yj, yt, j2, t2 = _run_both(j, t, xs)
    assert yt.dtype == yj.dtype and t2.v.dtype == td and t2.parallel
    assert _rel(yj, yt) < tol
    assert _rel(np.asarray(j2.v), t2.v.numpy()) < tol
    ys, _ = t.replace(parallel=False).execute_block(torch.from_numpy(xs[0]))
    assert _rel(ys.numpy(), yt[:, :N_PAR]) < tol


def test_parallel_route_block_split():
    """tests/test_iir_parallel.py::test_block_split_invariance on the port:
    one block of 1024 against two of 512, a 5th-order Butterworth."""
    f = IirFilter.create_lowpass(5, 0.2, device=DEV).parallelize()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(1024).astype(np.float32))
    y_all, f_all = f.execute_block(x)
    y_a, f2 = f.execute_block(x[:512])
    y_b, f2 = f2.execute_block(x[512:])
    assert _rel(y_all, torch.cat([y_a, y_b])) < SPLIT_TOL
    assert _rel(f_all.v, f2.v) < SPLIT_TOL


def test_parallel_real_state_stays_real():
    """A real state carried through a complex-coefficient filter comes back
    as its real part (iirfilt.py:262-265), as in yagi_tpu."""
    rng = np.random.default_rng(22)
    b, a = _tf_coefs(rng, 2, True)
    x = _signal(rng, (2, 64), False)
    yj, j = _jblock(JIir.create(b, a, batch_shape=(2,)).parallelize(), jnp.asarray(x))
    yt, t = IirFilter.create(b, a, batch_shape=(2,), device=DEV).parallelize().execute_block(
        torch.from_numpy(x))
    assert t.v.dtype == torch.float32 and yt.dtype == torch.complex64
    assert _rel(yj, yt.numpy()) < TF_TOL and _rel(np.asarray(j.v), t.v.numpy()) < TF_TOL


def test_sequential_route_needs_a_complex_state_for_a_complex_signal():
    f = IirFilter.create([0.5], [1.0, -0.5], device=DEV)
    with pytest.raises(TypeError, match="complex dtype"):
        f.execute_block(torch.zeros(4, dtype=torch.complex64))


def test_execute_one_sample_and_reset():
    rng = np.random.default_rng(23)
    b, a = _tf_coefs(rng, 3)
    j = JIir.create(b, a, batch_shape=(2,))
    t = IirFilter.create(b, a, batch_shape=(2,), device=DEV)
    for _ in range(5):
        x = _signal(rng, (2,), False)
        yj, j = j.execute(jnp.asarray(x))
        yt, t = t.execute(torch.from_numpy(x))
        assert yt.shape == (2,) and _rel(yj, yt.numpy()) < SEQ_TOL
    assert _rel(np.asarray(j.v), t.v.numpy()) < SEQ_TOL
    assert not t.reset().v.any() and t.reset().v.shape == t.v.shape


@pytest.mark.parametrize("kind", ["tf4", "tf3c", "lowpass7", "cheby1_tf", "dc_blocker", "pll",
                                  "integrator"])
def test_analysis_matches_yagi_tpu(kind):
    """nsos, get_length, scale, frequency response and group delay."""
    rng = np.random.default_rng(24)
    j, t = _make(kind, rng, "j"), _make(kind, rng, "t")
    assert (t.nsos, t.get_length(), t.sos_form) == (j.nsos, j.get_length(), j.sos_form)
    assert t.get_scale().item() == pytest.approx(complex(np.asarray(j.get_scale())))
    t2 = t.set_scale(0.5)
    assert t2.scale.dtype == t.scale.dtype and t2.get_scale().item() == 0.5
    for fc in (0.0, 0.05, 0.21, -0.3):  # the integrator's pole at z = 1: NaN at 0 in both
        np.testing.assert_allclose(t.freqresponse(fc), j.freqresponse(fc), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(t.groupdelay(fc), j.groupdelay(fc), rtol=1e-6, atol=1e-6)


_BAD_FILTERS = [
    ("create", ([], [1.0])),
    ("create", ([1.0], [])),
    ("create", ([1.0], [0.0, 1.0])),
    ("create_sos", (np.zeros((0, 3)), np.zeros((0, 3)))),
    ("create_sos", (np.ones((2, 3)), np.ones((1, 3)))),
    ("create_dc_blocker", (0.0,)),
    ("create_pll", (0.0, 0.7, 1.0)),
    ("create_pll", (0.1, 1.0, 1.0)),
    ("create_pll", (0.1, 0.7, -1.0)),
    ("create_lowpass", (0, 0.1)),
    ("create_lowpass", (4, 0.6)),
]


@pytest.mark.parametrize("ctor, args", _BAD_FILTERS)
def test_constructors_reject_what_yagi_tpu_rejects(ctor, args):
    with pytest.raises(JConfigError):
        getattr(JIir, ctor)(*args)
    with pytest.raises(ConfigError):
        getattr(IirFilter, ctor)(*args, device=DEV)


@pytest.mark.parametrize("parallel", [False, True])
def test_biquad_matches_yagi_tpu(parallel):
    """IirFilterSos: two blocks, one sample at a time too, and the group
    delay."""
    b, a = [0.2, 0.3, 0.1], [1.0, -0.5, 0.2]
    rng = np.random.default_rng(6)
    j = JSos.create(b, a, batch_shape=(3,))
    t = IirFilterSos.create(b, a, batch_shape=(3,), device=DEV)
    if parallel:
        j, t = j.parallelize(), t.parallelize()
    xs = [_signal(rng, (3, N_PAR), False) for _ in range(2)]
    yj, yt, j, t = _run_both(j, t, xs)
    assert _rel(yj, yt) < (TF_TOL if parallel else SEQ_TOL)
    assert t.v.shape == (3, 2) and _rel(np.asarray(j.v), t.v.numpy()) < TF_TOL
    x = _signal(rng, (3,), False)
    y1j, _ = j.execute(jnp.asarray(x))
    y1t, t1 = t.execute(torch.from_numpy(x))
    assert _rel(y1j, y1t.numpy()) < TF_TOL and t1.v.shape == (3, 2)
    # yagi_tpu's IirFilterSos.groupdelay names a function its design
    # package does not export; the port's is iirfiltsos.rs:120's formula
    b32, a32 = np.float32(b).astype(np.float64), np.float32(a).astype(np.float64)
    assert t.groupdelay(0.1) == pytest.approx(jdes.iir_group_delay(b32, a32, 0.1) + 2.0, rel=1e-6)
    assert not t.reset().v.any()


def test_biquad_rejects_what_yagi_tpu_rejects():
    for args in (([0.2, 0.3], [1.0, -0.5, 0.25]), ([0.2, 0.3, 0.1], [1.0, -0.5]),
                 ([0.2, 0.3, 0.1], [0.0, -0.5, 0.25])):
        with pytest.raises(JConfigError):
            JSos.create(*args)
        with pytest.raises(ConfigError):
            IirFilterSos.create(*args, device=DEV)


@pytest.mark.parametrize("kind", ["lowpass7", "tf3c"])
def test_load_state_round_trip(kind):
    """load_state carries a yagi_tpu filter mid-stream, its static sos_form
    and parallel passing through unchanged; both continue alike."""
    rng = np.random.default_rng(25)
    jd = jnp.complex64
    j = _with_dtype(_make(kind, rng, "j"), jd).parallelize()
    x = _signal(rng, (3, 50), True)
    _, j = _jblock(j, jnp.asarray(x))
    t = load_state(IirFilter, j, device=DEV)
    assert (t.sos_form, t.parallel) == (j.sos_form, True) and t.v.dtype == torch.complex64
    x2 = _signal(rng, (3, 60), True)
    yj, _ = _jblock(j, jnp.asarray(x2))
    yt, _ = t.execute_block(torch.from_numpy(x2))
    assert _rel(yj, yt.numpy()) < SOS_TOL


def test_create_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: IirFilter.create([1.0], [1.0, -0.5]), lambda: IirFilter.create_lowpass(3, 0.1),
                 lambda: IirFilterSos.create([1, 0, 0], [1, 0, 0])):
        with pytest.raises(DeviceError):
            make()
    assert IirFilter.create_integrator(device=DEV).v.device.type == "cpu"


# ------------------------------------------------ allpole_parallel, plain versions
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("complex_sig", [False, True], ids=["real", "complex"])
def test_allpole_parallel_matches_yagi_tpu(m, complex_sig):
    """The log-depth all-pole scan, v_init newest first, (v0, v_final)."""
    rng = np.random.default_rng(30 + m)
    _, a = _tf_coefs(rng, m)
    a_tail = a[1:].astype(np.float32)
    v = _signal(rng, (3, m), complex_sig)
    x = _signal(rng, (3, N_PAR), complex_sig)
    v0j, vfj = _jallpole(jnp.asarray(a_tail), jnp.asarray(v), jnp.asarray(x))
    v0t, vft = allpole_parallel(torch.from_numpy(a_tail), torch.from_numpy(v), torch.from_numpy(x))
    assert v0t.shape == (3, N_PAR) and vft.shape == (3, m)
    assert _rel(v0j, v0t.numpy()) < TF_TOL and _rel(vfj, vft.numpy()) < TF_TOL


def test_allpole_parallel_edges():
    """No feedback (m = 0: yagi_tpu's general path cannot take it) passes x
    and the state through; an empty block keeps the state."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(_signal(rng, (3, 17), True))
    v0, vf = allpole_parallel(torch.zeros(0), torch.zeros(3, 0, dtype=torch.complex64), x)
    assert torch.equal(v0, x) and vf.shape == (3, 0)
    v = torch.from_numpy(_signal(rng, (3, 2), False))
    v0, vf = allpole_parallel(torch.tensor([0.5, -0.1]), v, torch.zeros(3, 0))
    assert v0.shape == (3, 0) and torch.equal(vf, v)


def _kernel_args(rng, form: str, n, typ: str, c: int, t: int):
    """(x, b, a, scale, v) for the kernel wrappers: TF with n taps or SOS with
    the 7th-order Butterworth's sections, a scale other than 1 and a random
    state, as chip_smoke.py's iir_case builds them."""
    cx, cc = typ != "rrrf", typ == "cccf"
    sig = torch.complex64 if cx else torch.float32
    if form == "tf":
        f = IirFilter.create(*_tf_coefs(rng, n - 1, cc), device=DEV)
        v = torch.from_numpy(_signal(rng, (c, n - 1), cx))
    else:
        f = IirFilter.create_lowpass(7, 0.1, device=DEV)
        v = torch.from_numpy(_signal(rng, (c, f.nsos, 2), cx))
    scale = torch.tensor(0.7 + 0.2j if cc else 0.7, dtype=f.b.dtype)
    return torch.from_numpy(_signal(rng, (c, t), cx)).to(sig), f.b, f.a, scale, v


@pytest.mark.parametrize("form, n, typ", [("tf", 1, "rrrf"), ("tf", 2, "rrrf"), ("tf", 3, "crcf"),
                                          ("tf", 5, "cccf"), ("tf", 10, "rrrf"),
                                          ("sos", None, "rrrf"), ("sos", None, "crcf")])
def test_plain_versions_match_yagi_tpu(form, n, typ):
    """iir_scan_reference against yagi_tpu's sequential route, and
    iir_chunked_reference against its parallel route, from a nonzero state;
    the two plain versions against each other; on CPU tensors the wrappers
    run them and count no launch."""
    rng = np.random.default_rng(40)
    x, b, a, scale, v = _kernel_args(rng, form, n, typ, 3, N_PAR)
    sos = form == "sos"
    if sos:
        j = JIir(sos_form=True, b=jnp.asarray(b.numpy()), a=jnp.asarray(a.numpy()),
                 scale=jnp.asarray(scale.numpy()), v=jnp.asarray(v.numpy()))
    else:
        j = JIir(sos_form=False, b=jnp.asarray(b.numpy()), a=jnp.asarray(a.numpy()),
                 scale=jnp.asarray(scale.numpy()), v=jnp.asarray(v.numpy()))
    tol = SOS_TOL if sos else TF_TOL
    ys, vs = kiir.iir_scan_reference(x, b, a, scale, v, sos=sos)
    yc, vc = kiir.iir_chunked_reference(x, b, a, scale, v, sos=sos)
    assert ys.dtype == yc.dtype == x.dtype and vs.shape == vc.shape == v.shape
    if n == 1:  # no feedback, which yagi_tpu's routes cannot take: y = scale·b0·x
        assert torch.equal(ys, scale * (b[0] * x)) and torch.equal(vs, v)
        assert _rel(ys, yc) < tol and torch.equal(vc, v)
    else:
        yj, jq = _jblock(j, jnp.asarray(x.numpy()))
        assert _rel(yj, ys.numpy()) < SEQ_TOL and _rel(np.asarray(jq.v), vs.numpy()) < SEQ_TOL
        yjp, jp = _jblock(j.parallelize(), jnp.asarray(x.numpy()))
        assert _rel(yjp, yc.numpy()) < tol and _rel(np.asarray(jp.v), vc.numpy()) < tol
        assert _rel(ys, yc) < tol and _rel(vs, vc) < tol
    before = (kiir.iir_scan_apply.launches, kiir.iir_chunked_apply.launches)
    for apply, ref in ((kiir.iir_scan_apply, (ys, vs)), (kiir.iir_chunked_apply, (yc, vc))):
        got = apply(x, b, a, scale, v, sos=sos)
        assert all(torch.equal(g, w) for g, w in zip(got, ref))
    assert (kiir.iir_scan_apply.launches, kiir.iir_chunked_apply.launches) == before


def test_plain_versions_at_one_sample_and_none():
    rng = np.random.default_rng(41)
    for t in (0, 1):
        x, b, a, scale, v = _kernel_args(rng, "tf", 3, "crcf", 2, t)
        for fn in (kiir.iir_scan_reference, kiir.iir_chunked_reference):
            y, v_new = fn(x, b, a, scale, v, sos=False)
            assert y.shape == (2, t) and v_new.shape == v.shape
            if t == 0:
                assert torch.equal(v_new, v)


@pytest.mark.parametrize("bad", ["x_dtype", "x_rank", "coef_type", "sos_complex", "v_shape",
                                 "scale_dtype", "device", "empty_sos"])
def test_apply_rejects_bad_input(bad):
    rng = np.random.default_rng(42)
    x, b, a, scale, v = _kernel_args(rng, "tf", 3, "rrrf", 2, 16)
    sos = False
    if bad == "x_dtype":
        x = x.double()
    elif bad == "x_rank":
        x = x[0]
    elif bad == "coef_type":
        b, a, scale = b.to(torch.complex64), a.to(torch.complex64), scale.to(torch.complex64)
    elif bad == "sos_complex":
        x, b, a, scale, v = _kernel_args(rng, "sos", None, "crcf", 2, 16)
        b, a, scale = b.to(torch.complex64), a.to(torch.complex64), scale.to(torch.complex64)
        sos = True
    elif bad == "v_shape":
        v = v[:, :1].contiguous()
    elif bad == "scale_dtype":
        scale = scale.double()
    elif bad == "device":
        x = x.to("meta")
    else:
        b, a, v, sos = torch.zeros((0, 3)), torch.zeros((0, 3)), torch.zeros((2, 0, 2)), True
    for fn in (kiir.iir_scan_apply, kiir.iir_chunked_apply):
        with pytest.raises((ValueError, TypeError)):
            fn(x, b, a, scale, v, sos=sos)


# ------------------------------------------------------------- shape gates
_SLABS = {False: 4 * 8 * (256 * 4 + 16), True: 4 * 8 * (256 * 8 + 16)}


@pytest.mark.parametrize("state_len, cx, inst, smem", [
    (1, False, "tf1", _SLABS[False]),
    (8, True, "register", _SLABS[True]),
    (9, False, "shared", _SLABS[False] + 8 * 9 * 4),
    (2600, True, "shared", 232448),
    (2601, True, "global", _SLABS[True]),
    (6224, False, "shared", 232448),
    (6225, False, "global", _SLABS[False]),
])
def test_scan_instance_mirrors_the_kernel(state_len, cx, inst, smem):
    """iir_scan's instance: up to SCAN_REG state values in registers (TF of
    order 0, 1, 2 in its specialised instance), then a ring in shared memory
    while the card's 232,448 bytes hold it, then a ring in device memory: no
    state length the filters accept is refused."""
    assert kiir.scan_instance(state_len, cx) == (inst, smem)
    assert smem <= kiir.SMEM_LIMIT


@pytest.mark.parametrize("sos, order, want", [
    (False, 0, "tf0"), (False, 1, "tf1"), (False, 2, "tf2"), (False, 3, "register"),
    (False, 8, "register"), (False, 9, "shared"),
    (True, 1, "sos1"), (True, 2, "sos2"), (True, 3, "sos3"), (True, 4, "sos4"), (True, 5, "shared"),
])
@pytest.mark.parametrize("cx", [False, True], ids=["real", "complex"])
def test_scan_instance_picks_the_specialised_instance(sos, order, want, cx):
    """TF orders 0–2 and SOS filters of 1–4 sections run an instance with
    the order fixed at compile time; the other register states the generic
    one; longer states a ring. The name is one csrc/iir.cu numbers."""
    state_len = 2 * order if sos else order
    assert kiir.scan_instance(state_len, cx, sos)[0] == want
    assert want in kiir.SCAN_INSTANCES


@pytest.mark.parametrize("m, want", [(0, "generic"), (1, "order1"), (2, "order2"), (3, "generic"),
                                     (8, "generic")])
def test_chunked_instance_picks_the_specialised_instance(m, want):
    """iir_chunked runs stages of order 1 (config[2]'s de-emphasis) and 2
    (every SOS stage) with the order fixed at compile time."""
    assert kiir.chunked_instance(m) == want
    assert want in kiir.CHUNK_INSTANCES


@pytest.mark.parametrize("form, n, typ, scan_code, chunk_code", [
    ("tf", 2, "rrrf", 4, 1), ("tf", 3, "cccf", 5, 2), ("tf", 1, "crcf", 3, 0),
    ("tf", 6, "rrrf", 0, 0), ("sos", None, "crcf", 9, 2),
])
def test_wrappers_pass_the_chosen_instance(monkeypatch, form, n, typ, scan_code, chunk_code):
    """On a CUDA tensor the wrappers launch the instance the chooser names,
    by csrc/iir.cu's number (the launch itself is stood in for here)."""
    rng = np.random.default_rng(43)
    x, b, a, scale, v = _kernel_args(rng, form, n, typ, 2, 16)
    sos = form == "sos"
    seen = []
    monkeypatch.setattr(kiir, "route", lambda device, fn: "cuda")
    monkeypatch.setattr(kiir, "_launch", lambda fn, *args: seen.append((fn, args[-1])))
    kiir.iir_scan_apply(x, b, a, scale, v, sos=sos)
    kiir.iir_chunked_apply(x, b, a, scale, v, sos=sos)
    assert seen == [("yagi_iir_scan", scan_code), ("yagi_iir_chunked", chunk_code)]


def _chunked_smem(m, nst, cx, cc):
    e, mm, m2, npow = (8 if cx else 4), max(m, 1), m * m, 33
    return (2 * 128 * 32 * e + nst * (npow + 2) * m2 * (16 if cc else 8) + 2 * nst * (m + 1) * 8
            + nst * mm * 8 + 4 * mm * 8 + nst * npow * m2 * (8 if cc else 4))


@pytest.mark.parametrize("m, nst, cx, cc, fits", [
    (1, 1, False, False, True), (2, 4, True, False, True), (8, 1, True, True, True),
    (2, 97, True, False, True), (9, 1, False, False, False), (2, 98, True, False, False),
])
def test_chunked_gate_mirrors_the_kernel(m, nst, cx, cc, fits):
    """iir_chunked takes stages of order ≤ 8 whose two segment buffers,
    powers and working copies fit the card's shared memory; the rest go to
    iir_scan."""
    assert kiir.chunked_smem_bytes(m, nst, cx, cc) == _chunked_smem(m, nst, cx, cc)
    assert kiir.chunked_fits(m, nst, cx, cc) == fits


def test_python_mirror_matches_the_cu_constants():
    """kernels/iir.py's constants are csrc/iir.cu's."""
    src = (_build._CSRC / "iir.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    def enum(name):
        return int(re.search(rf"\b{name} = (\d+)\b", src).group(1))

    assert const("kSmemLimit") == kiir.SMEM_LIMIT
    assert const("kChans") == kiir.SCAN_CHANS
    assert const("kTile") == kiir.SCAN_TILE
    assert const("kReg") == kiir.SCAN_REG
    assert const("kCT") == kiir.CHUNK_THREADS
    assert const("kCL") == kiir.CHUNK_LEN
    assert const("kWarpLog") == kiir.CHUNK_WARP_LOG == (kiir.CHUNK_THREADS // 32).bit_length() - 1
    assert "constexpr int kNPow = 32 + kWarpLog - 1;" in src
    assert kiir.CHUNK_POWERS == 32 + kiir.CHUNK_WARP_LOG - 1
    assert const("kCMax") == kiir.CHUNK_MAX_M
    assert [enum(k) for k in ("kInstRegister", "kInstShared", "kInstGlobal")] == [
        kiir.SCAN_INSTANCES[k] for k in ("register", "shared", "global")]
    assert all(kiir.SCAN_INSTANCES[f"tf{m}"] == enum("kInstTf0") + m for m in range(3))
    assert all(kiir.SCAN_INSTANCES[f"sos{n}"] == enum("kInstSos1") + n - 1 for n in range(1, 5))
    assert [enum(k) for k in ("kChunkGeneric", "kChunkOrder1", "kChunkOrder2")] == [
        kiir.CHUNK_INSTANCES[k] for k in ("generic", "order1", "order2")]
    assert '#include "iir.cuh"' in src


# ------------------------------------------------- the chunked kernel's carry
def _chunk_carry_model(x, b, a, v, *, chunk, lanes, warps):
    """iir_chunked's algorithm for a TF filter, in float64 torch: segments of
    ``warps`` × ``lanes`` chunks of ``chunk`` samples; per segment each chunk
    runs the all-pole recurrence from a zero state (chunk 0 from the carried
    state); the end states are carried by a doubling scan inside each warp
    with Z(2^d), then across the warps' end states with Z(lanes·2^d), then
    each chunk adds Z(lane + 1) times the previous warp's end state, Z(k) =
    M^(chunk·k); each chunk reruns the DF-II step from the end state of the
    chunk before it; the last chunk's rerun state is carried. Returns
    (y before the scale, the new state)."""
    C, T = x.shape
    m = a.shape[0] - 1
    x, a, b, v = x.double(), a.double(), b.double(), v.double()
    M = torch.zeros(m, m, dtype=torch.float64)
    M[0] = -a[1:]
    M[1:, :-1] += torch.eye(m - 1, dtype=torch.float64)
    Z = {k: torch.linalg.matrix_power(M, chunk * k) for k in [*range(1, lanes + 1)] +
         [lanes << d for d in range(warps.bit_length())]}
    seg = chunk * lanes * warps
    ys, carry = [], v.clone()
    for t0 in range(0, T, seg):
        xs = x[:, t0:t0 + seg]
        n = xs.shape[1]
        xs = torch.nn.functional.pad(xs, (0, seg - n)).reshape(C, warps * lanes, chunk)
        live = (torch.arange(seg).reshape(warps * lanes, chunk) < n)  # [chunks, chunk]
        s = torch.zeros(C, warps * lanes, m, dtype=torch.float64)
        s[:, 0] = carry
        for i in range(chunk):  # 1. all-pole from zero (chunk 0 from the carry)
            v0 = xs[:, :, i] - (s * a[1:]).sum(-1)
            s = torch.where(live[:, i, None], torch.cat([v0[..., None], s[..., :-1]], -1), s)
        s = s.reshape(C, warps, lanes, m)
        for d in range(lanes.bit_length() - 1):  # 2. inside each warp
            h = 1 << d
            p = torch.nn.functional.pad(s, (0, 0, h, 0))[:, :, :lanes]
            s = s + p @ Z[h].T
        tot = s[:, :, -1]
        for d in range(warps.bit_length() - 1):  # across the warps
            h = 1 << d
            tot = tot + torch.nn.functional.pad(tot, (0, 0, h, 0))[:, :warps] @ Z[lanes * h].T
        for lane in range(lanes):  # the previous warp's end state carried in
            s[:, 1:, lane] += tot[:, :-1] @ Z[lane + 1].T
        s = s.reshape(C, warps * lanes, m)
        e = torch.cat([carry[:, None], s[:, :-1]], 1)  # 3. the state entering each chunk
        y = torch.zeros(C, warps * lanes, chunk, dtype=torch.float64)
        for i in range(chunk):
            v0 = xs[:, :, i] - (e * a[1:]).sum(-1)
            y[:, :, i] = b[0] * v0 + (e * b[1:]).sum(-1)
            e = torch.where(live[:, i, None], torch.cat([v0[..., None], e[..., :-1]], -1), e)
        ys.append(y.reshape(C, seg)[:, :n])
        carry = e[:, (n - 1) // chunk]
    return torch.cat(ys, 1), carry


def _slow_tf_coefs(rng, order: int):
    """A real TF filter whose poles lie at radius 0.995 (conjugate pairs, and
    one real pole for an odd order): a state decays over ~200 samples, so
    the carry across chunks and across warps (Z(32) = 0.995^1024 ≈ 0.006)
    shows in the output."""
    ang = rng.uniform(0.05, 3.0, order // 2)
    poles = np.concatenate([0.995 * np.exp(1j * ang), 0.995 * np.exp(-1j * ang),
                            [0.995] * (order % 2)])
    return rng.standard_normal(order + 1) * 0.3, np.poly(poles).real


@pytest.mark.parametrize("order", [1, 2, 8])
def test_chunk_carry_model_matches_the_sequential_recurrence(order):
    """The chunked kernel's carry (chunks of CHUNK_LEN, 32 lanes a warp,
    CHUNK_THREADS / 32 warps a block, segments carried one to the next), as a
    float64 model, against iir_scan_reference over a T across two segments
    with a ragged last chunk, from a nonzero state, with poles slow enough
    that every level of the carry shows: the scan's tree and powers are the
    same recurrence."""
    rng = np.random.default_rng(44 + order)
    seg = kiir.CHUNK_THREADS * kiir.CHUNK_LEN
    b, a = (torch.from_numpy(c).float() for c in _slow_tf_coefs(rng, order))
    x = torch.from_numpy(_signal(rng, (3, seg + 1000), False)).float()
    v = torch.from_numpy(_signal(rng, (3, order), False)).float()
    scale = torch.tensor(0.7)
    y_ref, v_ref = kiir.iir_scan_reference(x, b, a, scale, v, sos=False)
    y, v_new = _chunk_carry_model(x, b, a, v, chunk=kiir.CHUNK_LEN, lanes=32,
                                  warps=kiir.CHUNK_THREADS // 32)
    assert _rel(y_ref, (0.7 * y).float()) < TF_TOL
    assert _rel(v_ref, v_new.float()) < TF_TOL
