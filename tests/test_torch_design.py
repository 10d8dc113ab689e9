"""Host-side design math of yagi_tpu_torch equals yagi_tpu's bit for bit: it
is copied numpy, so the filters both packages run start from identical taps."""

import numpy as np
import pytest
import torch

import yagi_tpu.design as jdesign
from yagi_tpu.design import fir_design_kaiser as j_kaiser
from yagi_tpu.errors import ConfigError as JConfigError
from yagi_tpu.filter.firpfb import pfb_decompose as j_pfb
from yagi_tpu.kernels.chain import chain_matrices as j_chain
import yagi_tpu_torch.design as tdesign
from yagi_tpu_torch.design import fir_design_kaiser
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.filter import pfb_decompose
from yagi_tpu_torch.kernels import chain_matrices

torch.set_num_threads(1)

# (n, fc, as_, mu): config[0]'s FIR and PFB prototype, plus each branch of
# the Kaiser beta rule (as_ > 50, 21 < as_ ≤ 50, as_ ≤ 21) and a nonzero mu
_KAISER = [
    (64, 0.2, 60.0, 0.0),
    (3585, 0.25 / 256, 60.0, 0.0),
    (57, 0.2, 60.0, 0.0),
    (21, 0.1, 30.0, 0.2),
    (11, 0.45, 15.0, -0.3),
    (1, 0.25, 60.0, 0.0),
]


@pytest.mark.parametrize("n,fc,as_,mu", _KAISER)
def test_fir_design_kaiser_bit_exact(n, fc, as_, mu):
    np.testing.assert_array_equal(fir_design_kaiser(n, fc, as_, mu), j_kaiser(n, fc, as_, mu))


@pytest.mark.parametrize("fc,mu", [(0.0, 0.0), (0.6, 0.0), (0.2, 0.51), (0.2, -0.5)])
def test_fir_design_kaiser_rejects(fc, mu):
    with pytest.raises(JConfigError):
        j_kaiser(16, fc, 60.0, mu)
    with pytest.raises(ConfigError):
        fir_design_kaiser(16, fc, 60.0, mu)


@pytest.mark.parametrize("length,npfb", [(3584, 256), (3585, 256), (640, 64), (100, 32)])
def test_pfb_decompose_bit_exact(length, npfb):
    h = np.random.default_rng(length).standard_normal(length).astype(np.float32)
    np.testing.assert_array_equal(pfb_decompose(h, npfb), j_pfb(h, npfb))


def _chain_inputs(n_taps, fc, as_, m, npfb):
    h = fir_design_kaiser(n_taps, fc, as_, 0.0)
    n = 2 * m * npfb + 1
    hf = fir_design_kaiser(n, 0.25 / npfb, as_, 0.0)
    branches = pfb_decompose((hf * (npfb / np.sum(hf))).astype(np.float32)[: n - 1], npfb)
    return h, 2.0 * fc, branches


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize(
    "n_taps,fc,as_,m,npfb", [(64, 0.2, 60.0, 7, 256), (32, 0.1, 40.0, 3, 64)]
)
def test_chain_matrices_bit_exact(n_taps, fc, as_, m, npfb, p):
    h, scale, branches = _chain_inputs(n_taps, fc, as_, m, npfb)
    g = chain_matrices(h, scale, branches, p)
    assert g.shape == (2, 128, 128 * p) and g.dtype == np.float32
    np.testing.assert_array_equal(g, j_chain(h, scale, branches, p))


@pytest.mark.parametrize("p,n_taps", [(3, 64), (2, 128)])  # 3 ∤ npfb; K = 141 > 128
def test_chain_matrices_rejects(p, n_taps):
    h, scale, branches = _chain_inputs(n_taps, 0.2, 60.0, 7, 256)
    with pytest.raises(ValueError):
        j_chain(h, scale, branches, p)
    with pytest.raises(ValueError):
        chain_matrices(h, scale, branches, p)


# (shape, k, m, beta): config[1]'s symsync prototype (k·num_filters = 64),
# beta 1 and 0.5 (rcos and rrcos meet their special-case points) and
# Firpfbch's use
_PROTO = [(s, k, m, beta) for s in ("kaiser", "rcos", "rrcos")
          for k, m, beta in ((64, 7, 0.3), (2, 3, 1.0), (4, 2, 0.5), (8, 3, 0.25))]


@pytest.mark.parametrize("shape,k,m,beta", _PROTO)
def test_fir_design_prototype_bit_exact(shape, k, m, beta):
    want = jdesign.fir_design_prototype(jdesign.FirFilterShape.from_str(shape), k, m, beta, 0.0)
    got = tdesign.fir_design_prototype(tdesign.FirFilterShape.from_str(shape), k, m, beta, 0.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", ["pm", "fexp", "rkaiser", "hm3", "gmsktx", "rfsech"])
def test_fir_design_prototype_names_unported_shape(shape):
    """Shapes that once raised "not ported" now design the same taps as
    yagi_tpu, bit for bit."""
    want = jdesign.fir_design_prototype(jdesign.FirFilterShape.from_str(shape), 2, 3, 0.3)
    got = tdesign.fir_design_prototype(tdesign.FirFilterShape.from_str(shape), 2, 3, 0.3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,as_", [(3, 65.0), (5, 65.0), (12, 70.0), (2, 40.0)])
def test_pm_halfband_bit_exact(m, as_):
    np.testing.assert_array_equal(
        tdesign.fir_design_pm_halfband_stopband_attenuation(m, as_),
        jdesign.fir_design_pm_halfband_stopband_attenuation(m, as_))


@pytest.mark.parametrize("df,as_", [(0.1, 65.0), (0.02, 80.0), (0.3, 40.0)])
def test_filter_length_estimators_bit_exact(df, as_):
    assert tdesign.estimate_req_filter_len(df, as_) == jdesign.estimate_req_filter_len(df, as_)
    n = jdesign.estimate_req_filter_len(df, as_)
    assert (tdesign.estimate_req_filter_stopband_attenuation(df, n)
            == jdesign.estimate_req_filter_stopband_attenuation(df, n))
    assert (tdesign.estimate_req_filter_transition_bandwidth(as_, n)
            == jdesign.estimate_req_filter_transition_bandwidth(as_, n))
