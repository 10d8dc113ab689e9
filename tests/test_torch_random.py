"""yagi_tpu_torch.random against yagi_tpu on the CPU: every pdf and cdf at
1e-12 relative; each sampler on a ``torch.Generator`` held to its own cdf
at the deciles within 0.02 (tests/test_aux.py:80-87's test, n = 20000); the
cawgn power within 5%; the same seed draws the same values and another
seed other values; the ConfigErrors of tests/test_aux.py:97-107; the
scramblers exact; Modem.random_symbol(s) in [0, M) and deterministic.
"""

import numpy as np
import pytest
import torch

import yagi_tpu.random as jr
import yagi_tpu_torch.random as tr
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.modem import Modem

torch.set_num_threads(1)

DEV = "cpu"  # the samplers draw on the CPU, from CPU generators

PDF_RTOL = 1e-12
DECILE_TOL = 0.02  # tests/test_aux.py:87
N_DRAWS = 20000


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


# name: (arguments after x, a grid of x)
_X = np.concatenate([np.linspace(-1.0, 6.0, 57), [0.0, 1e-9, 1.0, 2.0]])
PDF_CDF_CASES = {
    "randf": ((), _X),
    "randuf": ((-0.5, 2.5), _X),
    "randnf": ((0.3, 1.7), _X),
    "randexpf": ((2.3,), _X),
    "randgammaf": ((2.5, 1.2), _X),
    "randgammaf small": ((0.6, 0.8), _X),
    "randnakmf": ((1.5, 1.0), _X),
    "randnakmf m=0.5": ((0.5, 2.0), _X),
    "randricekf": ((2.0, 1.0), _X),
    "randricekf k=0": ((0.0, 1.5), _X),
    "randweibf": ((2.0, 1.5, 0.0), _X),
    "randweibf shifted": ((0.7, 1.0, 0.5), _X),
}


@pytest.mark.parametrize("case", sorted(PDF_CDF_CASES))
def test_pdf_cdf_match(case):
    args, x = PDF_CDF_CASES[case]
    name = case.split()[0]
    for kind in ("_pdf", "_cdf"):
        got = getattr(tr, name + kind)(x, *args)
        want = getattr(jr, name + kind)(x, *args)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=PDF_RTOL, atol=0, err_msg=case + kind)


SAMPLERS = {
    "uniform": (lambda g, n: tr.randf(g, (n,), device=DEV), lambda x: tr.randf_cdf(x)),
    "uniform ab": (lambda g, n: tr.randuf(g, -0.5, 2.5, (n,), device=DEV),
                   lambda x: tr.randuf_cdf(x, -0.5, 2.5)),
    "normal": (lambda g, n: tr.randnf(g, (n,), device=DEV), lambda x: tr.randnf_cdf(x, 0.0, 1.0)),
    "complex normal re": (lambda g, n: tr.crandnf(g, (n,), device=DEV).real,
                          lambda x: tr.randnf_cdf(x, 0.0, 1.0)),
    "complex normal im": (lambda g, n: tr.crandnf(g, (n,), device=DEV).imag,
                          lambda x: tr.randnf_cdf(x, 0.0, 1.0)),
    "exp": (lambda g, n: tr.randexpf(g, 2.3, (n,), device=DEV), lambda x: tr.randexpf_cdf(x, 2.3)),
    "gamma": (lambda g, n: tr.randgammaf(g, 2.5, 1.2, (n,), device=DEV),
              lambda x: tr.randgammaf_cdf(x, 2.5, 1.2)),
    "gamma alpha<1": (lambda g, n: tr.randgammaf(g, 0.6, 0.8, (n,), device=DEV),
                      lambda x: tr.randgammaf_cdf(x, 0.6, 0.8)),
    "nakagami": (lambda g, n: tr.randnakmf(g, 1.5, 1.0, (n,), device=DEV),
                 lambda x: tr.randnakmf_cdf(x, 1.5, 1.0)),
    "rice": (lambda g, n: tr.randricekf(g, 2.0, 1.0, (n,), device=DEV),
             lambda x: tr.randricekf_cdf(x, 2.0, 1.0)),
    "weibull": (lambda g, n: tr.randweibf(g, 2.0, 1.5, 0.0, (n,), device=DEV),
                lambda x: tr.randweibf_cdf(x, 2.0, 1.5, 0.0)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_deciles(name):
    sampler, cdf = SAMPLERS[name]
    x = sampler(_gen(7), N_DRAWS)
    assert x.shape == (N_DRAWS,) and x.dtype == torch.float32 and x.device.type == DEV
    assert bool(torch.isfinite(x).all())
    s = np.sort(x.numpy())
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert cdf(np.array([s[int(q * N_DRAWS)]]))[0] == pytest.approx(q, abs=DECILE_TOL), q


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_seeded(name):
    sampler, _ = SAMPLERS[name]
    a, b, c = sampler(_gen(11), 512), sampler(_gen(11), 512), sampler(_gen(12), 512)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_cawgn_power_and_awgn():
    x = torch.zeros(50000, dtype=torch.complex64)
    y = tr.cawgn(_gen(0), x, 0.5)
    assert y.dtype == torch.complex64
    assert y.abs().square().mean().item() == pytest.approx(0.25, rel=0.05)
    r = tr.awgn(_gen(0), torch.zeros(50000), 0.5)
    assert r.dtype == torch.float32
    assert r.square().mean().item() == pytest.approx(0.25, rel=0.05)
    # a numpy input goes to the device asked for
    assert tr.awgn(_gen(1), np.ones(8, np.float32), 0.1, device=DEV).device.type == DEV


def test_scalar_shape_and_device_default(monkeypatch):
    assert tr.randnf(_gen(3), device=DEV).shape == ()
    assert tr.randgammaf(_gen(3), 0.3, 1.0, 5, device=DEV).shape == (5,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        tr.randf(_gen(3), (4,))


def test_invalid():
    g = _gen(0)
    with pytest.raises(ConfigError):
        tr.randexpf(g, -1.0, device=DEV)
    with pytest.raises(ConfigError):
        tr.randgammaf(g, 0.0, 1.0, device=DEV)
    with pytest.raises(ConfigError):
        tr.randgammaf(g, 1.0, 0.0, device=DEV)
    with pytest.raises(ConfigError):
        tr.randnakmf(g, 0.3, 1.0, device=DEV)
    with pytest.raises(ConfigError):
        tr.randnakmf(g, 1.0, 0.0, device=DEV)
    with pytest.raises(ConfigError):
        tr.randuf(g, 2.0, 1.0, device=DEV)
    with pytest.raises(ConfigError):
        tr.randricekf(g, -1.0, 1.0, device=DEV)
    with pytest.raises(ConfigError):
        tr.randweibf(g, 0.0, 1.0, device=DEV)
    for fn, args in ((tr.randnf_pdf, (0.0, 0.0)), (tr.randnf_cdf, (0.0, -1.0)),
                     (tr.randgammaf_cdf, (0.0, 1.0)), (tr.randnakmf_pdf, (0.4, 1.0)),
                     (tr.randricekf_cdf, (1.0, 0.0)), (tr.randweibf_pdf, (1.0, -1.0)),
                     (tr.randuf_pdf, (1.0, 1.0)), (tr.randexpf_cdf, (0.0,))):
        with pytest.raises(ConfigError):
            fn(np.ones(3), *args)


@pytest.mark.parametrize("n", [11, 16, 33, 64, 256, 277])
def test_scramble_exact(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    s = tr.scramble_data(data)
    np.testing.assert_array_equal(s, jr.scramble_data(data))
    np.testing.assert_array_equal(tr.unscramble_data(s), data)
    soft = rng.integers(0, 256, 8 * n, dtype=np.uint8)
    np.testing.assert_array_equal(tr.unscramble_data_soft(soft), jr.unscramble_data_soft(soft))
    hard = np.unpackbits(s).astype(np.uint8) * 255
    np.testing.assert_array_equal(tr.unscramble_data_soft(hard) > 127, np.unpackbits(data) > 0)


@pytest.mark.parametrize("scheme", ["bpsk", "qpsk", "qam16", "psk8", "apsk32", "qam256"])
def test_modem_random_symbols(scheme):
    m = Modem.create(scheme, device=DEV)
    M = m.constellation_size
    s = m.random_symbols(_gen(5), (4, 1000))
    assert s.shape == (4, 1000) and s.dtype == torch.int64 and s.device.type == DEV
    assert int(s.min()) >= 0 and int(s.max()) < M
    assert torch.equal(s, m.random_symbols(_gen(5), (4, 1000)))
    assert not torch.equal(s, m.random_symbols(_gen(6), (4, 1000)))
    assert torch.bincount(s.reshape(-1), minlength=M).min().item() > 0  # every symbol
    one = m.random_symbol(_gen(5))
    assert one.shape == () and one.dtype == torch.int64 and 0 <= int(one) < M
    # decoded points are the table's: modulate takes the draws
    y, _ = m.modulate(s[0])
    assert y.shape == (1000,)
