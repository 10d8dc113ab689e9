"""Layer L3 of yagi_tpu_torch against yagi_tpu: the rest of FIR design and
Parks-McClellan.

The port's design code is copied host numpy float64 on the same code
paths, so every design output, estimator and filter statistic must equal
yagi_tpu's exactly (``assert_array_equal`` and ``==``, as
tests/test_torch_design.py holds Kaiser). The objects built from the newly
ported prototype shapes (Symsync, the interpolator and decimator, Rresamp,
Eqlms) must hold the same tap tensors bit for bit, and the interpolator's
and decimator's outputs agree within 1e-5 (float32 streams).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yagi_tpu.design as jd
import yagi_tpu.math.windows as jwin
from yagi_tpu.equalization import Eqlms as JEqlms
from yagi_tpu.filter import FirDecimationFilter as JDecim
from yagi_tpu.filter import FirInterpolationFilter as JInterp
from yagi_tpu.filter import Rresamp as JRresamp
from yagi_tpu.filter import Symsync as JSymsync
import yagi_tpu_torch.design as td
import yagi_tpu_torch.math.windows as twin
from yagi_tpu_torch.equalization import Eqlms
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.filter import FirDecimationFilter, FirInterpolationFilter, Rresamp, Symsync

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

SHAPES = [s.value for s in jd.FirFilterShape]


# ------------------------------------------------------------ Parks-McClellan
_PM_CASES = [
    # (h_len, bands, des, weights, btype)
    (31, [0.0, 0.2, 0.3, 0.5], [1.0, 0.0], [1.0, 10.0], "bandpass"),
    (32, [0.0, 0.2, 0.3, 0.5], [1.0, 0.0], None, "bandpass"),
    (41, [0.0, 0.1, 0.15, 0.25, 0.3, 0.5], [0.0, 1.0, 0.0], [3.0, 1.0, 3.0], "bandpass"),
    (31, [0.0, 0.45], [1.0], None, "differentiator"),
    (32, [0.0, 0.5], [1.0], None, "differentiator"),
    (31, [0.05, 0.45], [1.0], None, "hilbert"),
    (30, [0.05, 0.5], [1.0], None, "hilbert"),
]


@pytest.mark.parametrize("h_len,bands,des,weights,btype", _PM_CASES)
def test_pm_band_types_bit_exact(h_len, bands, des, weights, btype):
    want = jd.FirDesignPm(h_len, bands, des, weights, None, jd.FirPmBandType(btype)).execute()
    got = td.FirDesignPm(h_len, bands, des, weights, None, td.FirPmBandType(btype)).execute()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        td.fir_design_pm(h_len, bands, des, weights, None, td.FirPmBandType(btype)), want)


def test_pm_callback_and_weight_types_bit_exact():
    cb = lambda f: (1.0 if f < 0.2 else 0.0, 1.0 + 4.0 * f)  # noqa: E731
    want = jd.FirDesignPm(25, [0.0, 0.15, 0.25, 0.5], None, callback=cb).execute()
    got = td.FirDesignPm(25, [0.0, 0.15, 0.25, 0.5], None, callback=cb).execute()
    np.testing.assert_array_equal(got, want)
    for wt in ("flat", "exp", "lin"):
        w = [jd.FirPmWeightType(wt)] * 2
        t = [td.FirPmWeightType(wt)] * 2
        np.testing.assert_array_equal(
            td.fir_design_pm(21, [0.0, 0.2, 0.3, 0.5], [1.0, 0.0], [1.0, 2.0], t),
            jd.fir_design_pm(21, [0.0, 0.2, 0.3, 0.5], [1.0, 0.0], [1.0, 2.0], w))


@pytest.mark.parametrize("n,fc,as_", [(31, 0.2, 60.0), (64, 0.1, 80.0), (17, 0.35, 40.0)])
def test_pm_lowpass_bit_exact(n, fc, as_):
    np.testing.assert_array_equal(td.fir_design_pm_lowpass(n, fc, as_),
                                  jd.fir_design_pm_lowpass(n, fc, as_))


@pytest.mark.parametrize("args", [(0, [0.0, 0.5], [1.0]), (11, [0.0, 0.2, 0.3], [1.0]),
                                  (11, [0.0, 0.6], [1.0]), (11, [0.3, 0.2], [1.0])])
def test_pm_rejects(args):
    with pytest.raises(ConfigError):
        td.FirDesignPm(*args)


# ------------------------------------------------------------ FIR designs
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k,m,beta", [(2, 3, 0.3), (4, 2, 0.5)])
def test_fir_design_prototype_every_shape_bit_exact(shape, k, m, beta):
    want = jd.fir_design_prototype(jd.FirFilterShape.from_str(shape), k, m, beta, 0.0)
    got = td.fir_design_prototype(td.FirFilterShape.from_str(shape), k, m, beta, 0.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fexp", "rfexp", "fsech", "rfsech", "farcsech", "rfarcsech",
                                  "gmsktx", "gmskrx", "rkaiser", "arkaiser", "hm3"])
@pytest.mark.parametrize("k,m,beta", [(2, 4, 0.25), (3, 2, 0.6)])
def test_named_designs_bit_exact(name, k, m, beta):
    fn = f"fir_design_{name}"
    np.testing.assert_array_equal(getattr(td, fn)(k, m, beta), getattr(jd, fn)(k, m, beta))


@pytest.mark.parametrize("wname", ["hamming", "hann", "blackmanharris", "kaiser", "flattop",
                                   "triangular", "rcostaper", "kbd"])
def test_fir_design_windowf_bit_exact(wname):
    n, arg = 33, {"kaiser": 6.0, "triangular": 33, "rcostaper": 4, "kbd": 3.0}.get(wname, 0.0)
    if wname == "kbd":
        n = 32  # the KBD window is even-length
    want = jd.fir_design_windowf(jwin.get_window_type(wname), n, 0.2, arg)
    got = td.fir_design_windowf(twin.get_window_type(wname), n, 0.2, arg)
    np.testing.assert_array_equal(got, want)


def test_dc_blocker_doppler_bit_exact():
    np.testing.assert_array_equal(td.fir_design_dc_blocker(10, 40.0),
                                  jd.fir_design_dc_blocker(10, 40.0))
    for n, fd, k, theta in ((51, 0.05, 2.0, 0.3), (20, 0.1, 0.5, 1.1)):
        np.testing.assert_array_equal(td.fir_design_doppler(n, fd, k, theta),
                                      jd.fir_design_doppler(n, fd, k, theta))


@pytest.mark.parametrize("df,as_", [(0.1, 60.0), (0.02, 80.0), (0.3, 40.0), (0.05, 120.0)])
def test_herrmann_estimate_equal(df, as_):
    assert td.estimate_req_filter_len_herrmann(df, as_) == \
        jd.estimate_req_filter_len_herrmann(df, as_)


def test_filter_statistics_equal():
    rng = np.random.default_rng(4)
    h = rng.standard_normal(37)
    g = rng.standard_normal(21)
    for lag in (-40, -20, -3, 0, 5, 17, 30, 36, 37):
        assert td.filter_autocorr(h, lag) == jd.filter_autocorr(h, lag)
        assert td.filter_crosscorr(h, g, lag) == jd.filter_crosscorr(h, g, lag)
        assert td.filter_crosscorr(g, h, lag) == jd.filter_crosscorr(g, h, lag)
    rr = jd.fir_design_rrcos(4, 5, 0.3)
    assert td.filter_isi(rr, 4, 5) == jd.filter_isi(rr, 4, 5)
    assert td.filter_energy(rr, 0.2, 256) == jd.filter_energy(rr, 0.2, 256)
    with pytest.raises(ConfigError):
        td.filter_energy(rr, 0.7, 256)


# ------------------------------------------- objects on the new prototypes
def _same_taps(t, j) -> int:
    """Every floating field of the port's object that yagi_tpu's has under
    the same name holds the same values bit for bit; returns their count."""
    n = 0
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name, None)
        if dataclasses.is_dataclass(tv):
            n += _same_taps(tv, jv)
            continue
        if not isinstance(tv, torch.Tensor) or jv is None:
            continue
        jv = np.asarray(jv)
        if tv.is_floating_point() or tv.is_complex():
            assert tuple(tv.shape) == jv.shape, f.name
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=f.name)
            n += 1
    return n


_OBJECTS = [
    (JSymsync.create_rnyquist, Symsync.create_rnyquist, ("fexp", 2, 3, 0.3), {"num_filters": 8}),
    (JInterp.create_prototype, FirInterpolationFilter.create_prototype, ("gmsktx", 2, 3, 0.3), {}),
    (JDecim.create_prototype, FirDecimationFilter.create_prototype, ("rkaiser", 2, 3, 0.3), {}),
    (JRresamp.create_prototype, Rresamp.create_prototype, ("arkaiser", 3, 2, 5, 0.3), {}),
    (JEqlms.create_rnyquist, Eqlms.create_rnyquist, ("hm3", 2, 3, 0.3), {}),
    (JInterp.create_prototype, FirInterpolationFilter.create_prototype, ("pm", 4, 3, 0.3), {}),
]


@pytest.mark.parametrize("jc,tc,args,kw", _OBJECTS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_objects_take_the_new_shapes(jc, tc, args, kw):
    j = jc(jd.FirFilterShape.from_str(args[0]), *args[1:], batch_shape=(2,), **kw)
    t = tc(td.FirFilterShape.from_str(args[0]), *args[1:], batch_shape=(2,), device=DEV, **kw)
    assert _same_taps(t, j) >= 2


@pytest.mark.parametrize("kind", ["interp", "decim"])
def test_prototype_filters_run_the_same(kind):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 96)) + 1j * rng.standard_normal((2, 96))).astype(np.complex64)
    if kind == "interp":
        j = JInterp.create_prototype(jd.FirFilterShape.RFSECH, 2, 3, 0.4, batch_shape=(2,))
        t = FirInterpolationFilter.create_prototype(td.FirFilterShape.RFSECH, 2, 3, 0.4,
                                                    batch_shape=(2,), device=DEV)
    else:
        j = JDecim.create_prototype(jd.FirFilterShape.GMSKRX, 2, 3, 0.4, batch_shape=(2,))
        t = FirDecimationFilter.create_prototype(td.FirFilterShape.GMSKRX, 2, 3, 0.4,
                                                 batch_shape=(2,), device=DEV)
    yj, _ = j.execute_block(jnp.asarray(x))
    yt, _ = t.execute_block(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
