"""yagi_tpu_torch's layer-L0 math against yagi_tpu on the CPU: the special
functions (1e-12 relative, over grids that cross each series' branch
points), modular arithmetic and bit utilities (exact), the complex helpers
on tensors (within one ulp of complex64 at the value's magnitude:
|a − b| ≤ 2^-23·|b|) and ``dotprod`` for the rrrf/crcf/cccf combinations at
tests/test_aux.py's lengths (|a − b| ≤ 1e-6·Σ|a_i·b_i|, the sum's scale).
"""

import numpy as np
import pytest
import torch

import yagi_tpu.math as jm
import yagi_tpu.utils.bits as jbits
import yagi_tpu_torch.math as tm
import yagi_tpu_torch.utils.bits as tbits
from yagi_tpu_torch.errors import ConfigError, DeviceError, ValueRangeError

torch.set_num_threads(1)

DEV = "cpu"  # the tensors of these tests live on the CPU

SPECIAL_RTOL = 1e-12
ULP32 = 2.0**-23
DOT_RTOL = 1e-6

# (function, argument tuples): each grid crosses the function's branches
# (z == 0, the small-argument form below 1e-3·√(ν + 1), ν = 0.5, the series'
# stopping rules, nchoosek's n > 12 route)
_ALPHAS = (1e-3, 0.05, 0.5, 1.0, 2.5, 7.0, 30.0)
_ZS = (0.3, 0.5, 1.0, 2.5, 4.0, 9.5)
SPECIAL_CASES = {
    "lngammaf": [(z,) for z in (1e-3, 0.5, 1.0, 1.5, 2.0, 7.3, 40.0, 170.5)],
    "gammaf": [(z,) for z in (-2.5, -0.5, 1e-3, 0.5, 1.0, 4.0, 10.5, 30.0)],
    "lnlowergammaf": [(z, a) for z in _ZS for a in _ALPHAS],
    "lowergammaf": [(z, a) for z in _ZS for a in _ALPHAS],
    "lnuppergammaf": [(z, a) for z in _ZS for a in _ALPHAS[:5]],
    "uppergammaf": [(z, a) for z in _ZS for a in _ALPHAS[:5]],
    "factorialf": [(n,) for n in range(0, 21)],
    "lnbesselif": [(nu, z) for nu in (0.0, 0.5, 1.0, 2.5) for z in (1e-5, 0.01, 0.7, 3.0, 25.0)],
    "besselif": [(nu, z) for nu in (0.0, 0.5, 1.0, 2.5) for z in (0.0, 1e-5, 0.01, 0.7, 3.0, 25.0)],
    "besseli0f": [(z,) for z in (0.0, 1e-4, 0.5, 2.0, 10.0, 40.0)],
    "besseljf": [(nu, z) for nu in (0.0, 0.5, 1.0, 2.5, -0.5)
                 for z in (0.0, 1e-5, 0.01, 0.7, 3.0, 12.0)],
    "besselj0f": [(z,) for z in (-7.5, -1.0, 0.0, 1e-5, 0.5, 2.404825557695773, 10.0)],
    "qf": [(z,) for z in (-6.0, -2.0, -0.5, 0.0, 0.5, 2.0, 6.0, 10.0)],
    "marcumqf": [(m, a, b) for m in (1, 2, 4) for a in (0.0, 0.5, 2.0) for b in (0.1, 1.0, 3.0)],
    "marcumq1f": [(a, b) for a in (0.1, 0.5, 2.0, 4.0) for b in (0.1, 1.0, 3.0, 6.0)],
    "sincf": [(x,) for x in (0.0, 1e-13, 0.25, -1.5, 3.0)],
    "nextpow2": [(x,) for x in (1, 2, 3, 64, 65, 1000)],
    "nchoosek": [(n, k) for n in (0, 5, 12, 13, 20, 40) for k in (0, 1, 3, 6) if k <= n],
}


@pytest.mark.parametrize("name", sorted(SPECIAL_CASES))
def test_special_matches_yagi_tpu(name):
    for args in SPECIAL_CASES[name]:
        got, want = getattr(tm, name)(*args), getattr(jm, name)(*args)
        np.testing.assert_allclose(got, want, rtol=SPECIAL_RTOL, atol=0, err_msg=f"{name}{args}")


def test_special_errors():
    with pytest.raises(ValueRangeError):
        tm.lngammaf(0.0)
    with pytest.raises(ValueRangeError):
        tm.lnlowergammaf(-1.0, 0.5)
    with pytest.raises(ValueRangeError):
        tm.nchoosek(3, 4)
    with pytest.raises(ValueRangeError):
        tm.nextpow2(0)
    np.testing.assert_array_equal(tm.sincf(np.linspace(-3, 3, 13)), jm.sincf(np.linspace(-3, 3, 13)))


# ------------------------------------------------------------------ modarith
@pytest.mark.parametrize("name,args", [
    ("is_prime", [(n,) for n in range(-2, 400)]),
    ("factor", [(n,) for n in range(2, 600)] + [(2**31 - 1,), (3 * 5 * 7 * 11 * 13 * 17,)]),
    ("unique_factor", [(n,) for n in range(2, 600)]),
    ("gcd", [(p, q) for p in (1, 6, 35, 120, -8, 97) for q in (1, 4, 21, 360, 12)]),
    ("modpow", [(b, e, n) for b in (2, 3, 10) for e in (0, 1, 7, 100) for n in (7, 13, 1000)]),
    ("primitive_root_prime", [(p,) for p in range(3, 300) if jm.is_prime(p)]),
    ("totient", [(n,) for n in range(1, 400)]),
])
def test_modarith_exact(name, args):
    for a in args:
        assert getattr(tm, name)(*a) == getattr(jm, name)(*a), (name, a)


def test_modarith_errors():
    with pytest.raises(ValueRangeError):
        tm.factor(1)
    with pytest.raises(ConfigError):
        tm.gcd(0, 3)
    with pytest.raises(ConfigError):
        tm.primitive_root_prime(4)
    with pytest.raises(ConfigError):  # 2 has no root past 1 in either package
        tm.primitive_root_prime(2)


# ---------------------------------------------------------------------- bits
_WORDS = [0, 1, 0x80000000, 0xFFFFFFFF, 0x12345678, 0xDEADBEEF] + [
    int(v) for v in np.random.default_rng(5).integers(0, 2**32, 40, dtype=np.uint64)]


@pytest.mark.parametrize("name", ["count_ones", "count_ones_mod2", "byte_reverse",
                                  "halfword_reverse", "word_reverse", "count_leading_zeros",
                                  "msb_index"])
def test_bits_unary_exact(name):
    for w in _WORDS + [w & 0xFFFF for w in _WORDS] + [w & 0xFF for w in _WORDS]:
        assert getattr(tbits, name)(w) == getattr(jbits, name)(w), (name, hex(w))


def test_bits_binary_exact():
    for x in _WORDS:
        for y in _WORDS[::3]:
            assert tbits.bdotprod(x, y) == jbits.bdotprod(x, y)
            assert tbits.count_bit_errors(x, y) == jbits.count_bit_errors(x, y)
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, 256, (2, 1000), dtype=np.uint8)
    assert tbits.count_bit_errors_array(a, b) == jbits.count_bit_errors_array(a, b)
    assert tbits.__all__ == jbits.__all__


# ------------------------------------------------------------------ complexm
def _complex_grid() -> np.ndarray:
    rng = np.random.default_rng(7)
    z = (rng.standard_normal(200) * 3 + 1j * rng.standard_normal(200) * 3).astype(np.complex64)
    edges = np.array([0.5, -0.5, 2.0 + 1e-3j, -2.0 - 1e-3j, 1e-3 + 2.0j, -1e-3 - 2.0j,
                      1.0, -1.0, 1j, -1j, 0.0, -3.0 + 1e-4j, 1e-6 + 1e-6j, 40.0 - 2.0j,
                      -1.0 + 1e-4j], dtype=np.complex64)  # near the branch cuts, ±1, ±i, 0
    return np.concatenate([z, edges])


@pytest.mark.parametrize("name", ["cexpf", "clogf", "csqrtf", "casinf", "cacosf", "catanf"])
def test_complexm_within_one_ulp(name):
    z = _complex_grid()
    with np.errstate(divide="ignore"):  # log 0, atan ±i: infinities in both
        want = getattr(jm, name)(z)  # complex128
    got = getattr(tm, name)(torch.from_numpy(z))
    assert got.dtype == torch.complex64 and got.device.type == DEV
    fin = np.isfinite(want)
    got = got.numpy().astype(np.complex128)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.where(fin, np.abs(got - np.where(fin, want, 0)), 0.0)
    bad = err > ULP32 * np.abs(np.where(fin, want, 0))
    assert not bad.any(), (z[bad], got[bad], want[bad])
    # float64 input keeps complex128, real float32 input gives complex64
    assert getattr(tm, name)(torch.from_numpy(z.astype(np.complex128))).dtype == torch.complex128
    assert getattr(tm, name)(torch.tensor([0.5, 2.0])).dtype == torch.complex64


def test_complexm_non_tensor_needs_a_device(monkeypatch):
    np.testing.assert_allclose(tm.cexpf(1j * np.pi / 2, device=DEV).numpy(), 1j, atol=1e-7)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        tm.clogf(2.0)


# ------------------------------------------------------------------- dotprod
def _dot_close(got, want, h, x):
    """|a − b| ≤ DOT_RTOL·Σ|h·x|: relative to the sum's own scale, which a
    cancelling sum does not shrink."""
    got = got.numpy().astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    scale = np.abs(h.astype(np.complex128) * x).sum(-1)
    assert np.all(np.abs(got - want) <= DOT_RTOL * scale), (got, want)


@pytest.mark.parametrize("kind,seed,lengths", [
    ("rrrf", 0, (1, 2, 3, 5, 7, 9, 3, 4, 7, 8, 15, 16, 17, 32, 35, 64, 79)),
    ("crcf", 1, (4, 7, 16, 35)),
    ("cccf", 2, (4, 16, 35)),
])
def test_dotprod_matches_yagi_tpu(kind, seed, lengths):
    rng = np.random.default_rng(seed)
    for n in lengths:
        h = rng.normal(size=n).astype(np.float32)
        if kind == "cccf":
            h = (h + 1j * rng.normal(size=n)).astype(np.complex64)
        x = rng.normal(size=n).astype(np.float32)
        if kind != "rrrf":
            x = (x + 1j * rng.normal(size=n)).astype(np.complex64)
        got = tm.dotprod(torch.from_numpy(h), torch.from_numpy(x))
        assert got.dtype == (torch.float32 if kind == "rrrf" else torch.complex64)
        _dot_close(got, jm.dotprod(h, x), h, x)


def test_dotprod_basic_and_batched():
    h = torch.tensor([1, -1, 1, -1, 1, -1, 1, -1], dtype=torch.float32)
    x = torch.arange(1, 9, dtype=torch.float32)
    assert tm.dotprod(h, x).item() == -4.0
    a = np.random.default_rng(3).normal(size=(3, 5, 12)).astype(np.complex64)
    b = np.random.default_rng(4).normal(size=(12,)).astype(np.complex64) * 1j
    got = tm.dotprod(torch.from_numpy(a), b)  # a tensor and an array: the tensor's device
    assert got.shape == (3, 5)
    _dot_close(got, jm.dotprod(a, b), a, b)
    # unconjugated
    z = torch.tensor([1j, 1 + 1j])
    assert tm.dotprod(z, z).item() == (1j) ** 2 + (1 + 1j) ** 2
