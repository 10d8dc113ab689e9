"""IIR filter design (host-side float64/complex128).

Copied from :mod:`yagi_tpu.design.iir` (filter/iir/design/), bit for bit:
analog prototypes
(butter.rs, cheby1.rs, cheby2.rs, ellip.rs, bessel.rs), frequency pre-warp +
bilinear transform + zpk→TF / zpk→SOS pipeline (mod.rs:207-493), LP→HP/BP
transforms (mod.rs:504-551), PLL loop filters (pll.rs).
"""

from __future__ import annotations

import enum
import math

import numpy as np

from ..errors import ConfigError, InternalError
from ..math.poly import poly_expandroots, poly_findroots

__all__ = [
    "IirFilterShape",
    "IirBandType",
    "IirFormat",
    "iir_design",
    "iir_design_butter_analog",
    "iir_design_cheby1_analog",
    "iir_design_cheby2_analog",
    "iir_design_ellip_analog",
    "iir_design_bessel_analog",
    "iir_design_freqprewarp",
    "iir_design_bilinear_a2d",
    "iir_design_d2tf",
    "iir_design_d2sos",
    "iir_design_lp2hp",
    "iir_design_lp2bp",
    "iir_design_is_stable",
    "iir_group_delay",
    "iir_design_pll_active_lag",
    "iir_design_pll_active_pi",
    "find_conjugate_pairs",
]


class IirFilterShape(enum.Enum):
    BUTTER = "butter"
    CHEBY1 = "cheby1"
    CHEBY2 = "cheby2"
    ELLIP = "ellip"
    BESSEL = "bessel"


class IirBandType(enum.Enum):
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    BANDSTOP = "bandstop"


class IirFormat(enum.Enum):
    TRANSFER_FUNCTION = "tf"
    SECOND_ORDER_SECTIONS = "sos"


# ------------------------------------------------------- analog prototypes
def iir_design_butter_analog(n: int):
    """Butterworth: n unit-circle poles, no zeros, unit gain (butter.rs:16)."""
    if n == 0:
        raise ConfigError("filter order must be greater than zero")
    r = n % 2
    L = (n - r) // 2
    pa = []
    for i in range(L):
        theta = (2.0 * (i + 1) + n - 1.0) * np.pi / (2.0 * n)
        pa.append(np.exp(1j * theta))
        pa.append(np.exp(-1j * theta))
    if r == 1:
        pa.append(-1.0 + 0j)
    return np.array([], dtype=np.complex128), np.asarray(pa), 1.0 + 0j


def iir_design_cheby1_analog(n: int, ep: float):
    """Chebyshev-I: poles on an ellipse, no zeros (cheby1.rs:17)."""
    if n == 0:
        raise ConfigError("filter order must be greater than zero")
    t0 = np.sqrt(1.0 + 1.0 / (ep * ep))
    tp = (t0 + 1.0 / ep) ** (1.0 / n)
    tm = (t0 - 1.0 / ep) ** (1.0 / n)
    b = 0.5 * (tp + tm)
    a = 0.5 * (tp - tm)
    r = n % 2
    L = (n - r) // 2
    pa = []
    for i in range(L):
        theta = (2.0 * (i + 1) + n - 1.0) * np.pi / (2.0 * n)
        pa.append(a * np.cos(theta) - 1j * b * np.sin(theta))
        pa.append(a * np.cos(theta) + 1j * b * np.sin(theta))
    if r == 1:
        pa.append(-a + 0j)
    pa = np.asarray(pa)
    ka = (1.0 if r == 1 else 1.0 / np.sqrt(1.0 + ep * ep)) * np.prod(pa)
    return np.array([], dtype=np.complex128), pa, ka


def iir_design_cheby2_analog(n: int, es: float):
    """Chebyshev-II: inverted-ellipse poles + imaginary zeros (cheby2.rs:18)."""
    if n == 0:
        raise ConfigError("filter order must be greater than zero")
    t0 = np.sqrt(1.0 + 1.0 / (es * es))
    tp = (t0 + 1.0 / es) ** (1.0 / n)
    tm = (t0 - 1.0 / es) ** (1.0 / n)
    b = 0.5 * (tp + tm)
    a = 0.5 * (tp - tm)
    r = n % 2
    L = (n - r) // 2
    pa = []
    for i in range(L):
        theta = (2.0 * (i + 1) + n - 1.0) * np.pi / (2.0 * n)
        pa.append(1.0 / (a * np.cos(theta) - 1j * b * np.sin(theta)))
        pa.append(1.0 / (a * np.cos(theta) + 1j * b * np.sin(theta)))
    if r == 1:
        pa.append(1.0 / (-a + 0j))
    za = []
    for i in range(L):
        theta = 0.5 * np.pi * (2.0 * (i + 1) - 1.0) / n
        za.append(-1.0 / (1j * np.cos(theta)))
        za.append(1.0 / (1j * np.cos(theta)))
    pa = np.asarray(pa)
    za = np.asarray(za) if za else np.array([], dtype=np.complex128)
    ka = np.prod(pa) / np.prod(za) if len(za) else np.prod(pa)
    return za, pa, ka


# elliptic design internals (ellip.rs, [Orfanidis:2006])
def _landen(k: float, n: int) -> np.ndarray:
    v = np.zeros(n)
    for i in range(n):
        kp = np.sqrt(1.0 - k * k)
        k = (1.0 - kp) / (1.0 + kp)
        v[i] = k
    return v


def _ellipk(k: float, n: int) -> tuple[float, float]:
    """Complete elliptic integrals (K(k), K(k')) (ellip.rs:41)."""
    kmin = 4e-4
    kmax = np.sqrt(1.0 - kmin * kmin)
    kp = np.sqrt(1.0 - k * k)
    if k > kmax:
        lam = -np.log(0.25 * kp)
        K = lam + 0.25 * (lam - 1.0) * kp * kp
    else:
        K = np.pi * 0.5 * np.prod(1.0 + _landen(k, n))
    if k < kmin:
        lam = -np.log(0.25 * k)
        Kp = lam + 0.25 * (lam - 1.0) * k * k
    else:
        Kp = np.pi * 0.5 * np.prod(1.0 + _landen(kp, n))
    return float(K), float(Kp)


def _ellipdeg(n: float, k1: float, n_iter: int) -> float:
    """Elliptic degree (ellip.rs:87)."""
    K1, K1p = _ellipk(k1, n_iter)
    q1 = np.exp(-np.pi * K1p / K1)
    q = q1 ** (1.0 / n)
    b = sum(q ** (m * (m + 1)) for m in range(n_iter))
    a = sum(q ** (m * m) for m in range(1, n_iter))
    g = b / (1.0 + 2.0 * a)
    return float(4.0 * np.sqrt(q) * g * g)


def _ellip_cd(u: complex, k: float, n: int) -> complex:
    wn = np.cos(u * np.pi * 0.5)
    for vi in _landen(k, n)[::-1]:
        wn = (1.0 + vi) * wn / (1.0 + vi * wn * wn)
    return wn


def _ellip_sn(u: complex, k: float, n: int) -> complex:
    wn = np.sin(u * np.pi * 0.5)
    for vi in _landen(k, n)[::-1]:
        wn = (1.0 + vi) * wn / (1.0 + vi * wn * wn)
    return wn


def _ellip_acd(w: complex, k: float, n: int) -> complex:
    v = _landen(k, n)
    for i in range(n):
        v1 = k if i == 0 else v[i - 1]
        w = w / (1.0 + np.sqrt(1.0 - w * w * v1 * v1)) * 2.0 / (1.0 + v[i])
    return np.arccos(w) * 2.0 / np.pi


def _ellip_asn(w: complex, k: float, n: int) -> complex:
    return 1.0 - _ellip_acd(w, k, n)


def iir_design_ellip_analog(n: int, ep: float, es: float):
    """Elliptic (Cauer) prototype via Landen/Jacobi (ellip.rs:204)."""
    fp = 1.0 / (2.0 * np.pi)
    n_iter = 7
    wp = 2.0 * np.pi * fp
    ws = wp * 1.1
    k1 = ep / es

    k = _ellipdeg(float(n), k1, n_iter)
    L = n // 2
    r = n % 2

    u = [(2.0 * (i + 1) - 1.0) / n for i in range(L)]
    zeta = [_ellip_cd(ui + 0j, k, n_iter) for ui in u]
    za_half = [1j * wp / (k * z) for z in zeta]
    v0 = -1j * _ellip_asn(1j / ep, k1, n_iter) / n
    pa_half = [wp * 1j * _ellip_cd(ui - 1j * v0, k, n_iter) for ui in u]
    pa0 = wp * 1j * _ellip_sn(1j * v0, k, n_iter)

    pa = []
    for p in pa_half:
        pa.extend([p, np.conj(p)])
    if r:
        pa.append(pa0)
    za = []
    for z in za_half:
        za.extend([z, np.conj(z)])
    pa = np.asarray(pa)
    za = np.asarray(za) if za else np.array([], dtype=np.complex128)
    ka = 1.0 if r == 1 else 1.0 / np.sqrt(1.0 + ep * ep)
    ka = ka * np.prod(pa)
    if len(za):
        ka = ka / np.prod(za)
    return za, pa, ka


def iir_design_bessel_analog(n: int):
    """Bessel prototype: roots of the reverse Bessel polynomial, renormalized
    by the approximate 3-dB frequency [Bianchi:2007] (bessel.rs:27-66).

    Root-finding uses the companion-matrix method on the exact reverse Bessel
    coefficients (the reference uses Orchard's recursion; same roots).
    """
    if n == 0:
        raise ConfigError("filter order must be greater than zero")
    # reverse Bessel polynomial coefficients (ascending):
    # a_k = (2n-k)! / (2^(n-k) k! (n-k)!)
    coeffs = np.array(
        [
            math.exp(
                math.lgamma(2 * n - k + 1)
                - math.lgamma(k + 1)
                - math.lgamma(n - k + 1)
                - (n - k) * math.log(2.0)
            )
            for k in range(n + 1)
        ]
    )
    pa = poly_findroots(coeffs)
    w3db = np.sqrt((2 * n - 1) * np.log(2.0))
    pa = pa / w3db
    ka = np.prod(pa)
    return np.array([], dtype=np.complex128), pa, ka


# ----------------------------------------------------- transform pipeline
def iir_design_freqprewarp(btype: IirBandType, fc: float, f0: float) -> float:
    """Frequency pre-warp [Constantinides:1967] (mod.rs:207)."""
    if btype == IirBandType.LOWPASS:
        return float(np.tan(np.pi * fc))
    if btype == IirBandType.HIGHPASS:
        return float(-np.cos(np.pi * fc) / np.sin(np.pi * fc))
    if btype == IirBandType.BANDPASS:
        return float(
            (np.cos(2 * np.pi * fc) - np.cos(2 * np.pi * f0)) / np.sin(2 * np.pi * fc)
        )
    return float(
        np.sin(2 * np.pi * fc) / (np.cos(2 * np.pi * fc) - np.cos(2 * np.pi * f0))
    )


def iir_design_bilinear_a2d(za, pa, ka, m: float):
    """Analog zpk → digital zpk via bilinear transform (mod.rs:236)."""
    za = np.asarray(za, dtype=np.complex128)
    pa = np.asarray(pa, dtype=np.complex128)
    npa = len(pa)
    nza = len(za)
    zd = np.empty(npa, dtype=np.complex128)
    pd = np.empty(npa, dtype=np.complex128)
    kd = complex(ka)
    for i in range(npa):
        zd[i] = (1.0 + za[i] * m) / (1.0 - za[i] * m) if i < nza else -1.0
        pd[i] = (1.0 + pa[i] * m) / (1.0 - pa[i] * m)
        kd *= (1.0 - pd[i]) / (1.0 - zd[i])
    return zd, pd, kd


def iir_design_d2tf(zd, pd, kd):
    """Digital zpk → (b, a) transfer function (mod.rs:376)."""
    zd = np.asarray(zd, dtype=np.complex128)
    pd = np.asarray(pd, dtype=np.complex128)
    n = len(pd)
    qa = poly_expandroots(pd)
    a = qa[::-1].real.astype(np.float64)
    qb = poly_expandroots(zd)
    b = (qb[::-1] * kd).real.astype(np.float64)
    return b, a


def find_conjugate_pairs(z, tol: float = 1e-6) -> np.ndarray:
    """Group complex-conjugate pairs, liquid's ordering (mod.rs:77-194).

    Pairs first (negative-imag first within a pair, pairs sorted by real
    part), pure-real elements last sorted by value.
    """
    z = np.asarray(z, dtype=np.complex128)
    n = len(z)
    paired = [False] * n
    pairs = []
    for i in range(n):
        if paired[i] or abs(z[i].imag) < tol:
            continue
        for j in range(i + 1, n):
            if paired[j] or abs(z[j].imag) < tol:
                continue
            if abs(z[i].imag + z[j].imag) < tol and abs(z[i].real - z[j].real) < tol:
                pairs.append(z[i])
                paired[i] = paired[j] = True
                break
    reals = sorted(
        (z[i].real for i in range(n) if not paired[i] and abs(z[i].imag) < tol)
    )
    if 2 * len(pairs) + len(reals) != n:
        raise InternalError("could not associate complex conjugate pairs")
    out = []
    # perfect the pairs (negative imag first), sort by real part
    cleaned = [p if p.imag < 0 else np.conj(p) for p in pairs]
    for p in sorted(cleaned, key=lambda c: c.real):
        out.extend([p, np.conj(p)])
    out.extend([r + 0j for r in reals])
    return np.asarray(out, dtype=np.complex128)


def iir_design_d2sos(zd, pd, kd):
    """Digital zpk → second-order sections (mod.rs:415-493).

    Returns (B, A) with shape [L+r, 3]; gain distributed as k^(1/(L+r)) over
    all sections, sign applied to the first.
    """
    zd = np.asarray(zd, dtype=np.complex128)
    pd = np.asarray(pd, dtype=np.complex128)
    n = len(pd)
    zp = find_conjugate_pairs(zd)
    pp = find_conjugate_pairs(pd)
    r = n % 2
    L = (n - r) // 2
    B = np.zeros((L + r, 3))
    A = np.zeros((L + r, 3))
    for i in range(L):
        p0, p1 = -pp[2 * i], -pp[2 * i + 1]
        z0, z1 = -zp[2 * i], -zp[2 * i + 1]
        A[i] = [1.0, (p0 + p1).real, (p0 * p1).real]
        B[i] = [1.0, (z0 + z1).real, (z0 * z1).real]
    if r == 1:
        A[L] = [1.0, (-pp[n - 1]).real, 0.0]
        B[L] = [1.0, (-zp[n - 1]).real, 0.0]
    k = complex(kd).real
    sgn = -1.0 if k < 0.0 else 1.0
    g = (k * sgn) ** (1.0 / (L + r))
    B *= g
    B[0] *= sgn
    return B, A


def iir_design_lp2hp(zd, pd):
    """LP → HP: negate digital zeros/poles (mod.rs:504)."""
    return -np.asarray(zd), -np.asarray(pd)


def iir_design_lp2bp(zd, pd, f0: float):
    """LP → BP: quadratic root transform, doubles order (mod.rs:529)."""
    zd = np.asarray(zd, dtype=np.complex128)
    pd = np.asarray(pd, dtype=np.complex128)
    c0 = np.cos(2.0 * np.pi * f0)

    def transform(v):
        out = np.empty(2 * len(v), dtype=np.complex128)
        for i, vi in enumerate(v):
            t0 = 1.0 + vi
            s = np.sqrt(c0 * c0 * t0 * t0 - 4.0 * vi)
            out[2 * i] = 0.5 * (c0 * t0 + s)
            out[2 * i + 1] = 0.5 * (c0 * t0 - s)
        return out

    return transform(zd), transform(pd)


def iir_design(
    ftype: IirFilterShape,
    btype: IirBandType,
    fmt: IirFormat,
    n: int,
    fc: float,
    f0: float,
    ap: float,
    as_: float,
):
    """Full IIR design pipeline (mod.rs:567-717).

    Returns (b, a) arrays: flat TF coefficients, or [L+r, 3] SOS matrices.
    """
    if fc <= 0.0 or fc >= 0.5:
        raise ConfigError("cutoff frequency out of range")
    if f0 < 0.0 or f0 > 0.5:
        raise ConfigError("center frequency out of range")
    if ap <= 0.0:
        raise ConfigError("pass-band ripple out of range")
    if as_ <= 0.0:
        raise ConfigError("stop-band ripple out of range")
    if n == 0:
        raise ConfigError("filter order must be > 0")

    r = n % 2
    if ftype == IirFilterShape.BUTTER:
        k0 = 1.0
        za, pa, _ = iir_design_butter_analog(n)
    elif ftype == IirFilterShape.CHEBY1:
        epsilon = np.sqrt(10.0 ** (ap / 10.0) - 1.0)
        k0 = 1.0 if r == 1 else 1.0 / np.sqrt(1.0 + epsilon * epsilon)
        za, pa, _ = iir_design_cheby1_analog(n, epsilon)
    elif ftype == IirFilterShape.CHEBY2:
        epsilon = 10.0 ** (-as_ / 20.0)
        k0 = 1.0
        za, pa, _ = iir_design_cheby2_analog(n, epsilon)
    elif ftype == IirFilterShape.ELLIP:
        gp = 10.0 ** (-ap / 20.0)
        gs = 10.0 ** (-as_ / 20.0)
        ep = np.sqrt(1.0 / (gp * gp) - 1.0)
        es = np.sqrt(1.0 / (gs * gs) - 1.0)
        k0 = 1.0 if r == 1 else 1.0 / np.sqrt(1.0 + ep * ep)
        za, pa, _ = iir_design_ellip_analog(n, ep, es)
    elif ftype == IirFilterShape.BESSEL:
        k0 = 1.0
        za, pa, _ = iir_design_bessel_analog(n)
    else:
        raise ConfigError(f"unknown IIR filter shape {ftype}")

    m = iir_design_freqprewarp(btype, fc, f0)
    zd, pd, kd = iir_design_bilinear_a2d(za, pa, k0, m)

    if btype in (IirBandType.HIGHPASS, IirBandType.BANDSTOP):
        zd, pd = iir_design_lp2hp(zd, pd)
    if btype in (IirBandType.BANDPASS, IirBandType.BANDSTOP):
        zd, pd = iir_design_lp2bp(zd, pd, f0)

    if fmt == IirFormat.TRANSFER_FUNCTION:
        return iir_design_d2tf(zd, pd, kd)
    return iir_design_d2sos(zd, pd, kd)


def iir_design_is_stable(b, a) -> bool:
    """All poles strictly inside the unit circle (mod.rs:730)."""
    a = np.asarray(a, dtype=np.float64)
    if len(a) < 2:
        raise ConfigError("filter order too low")
    roots = poly_findroots(a[::-1])
    return bool(np.all(np.abs(roots) <= 1.0))


def iir_group_delay(b, a, fc: float) -> float:
    """IIR group delay at fc (mod.rs:771)."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    if len(b) == 0 or len(a) == 0:
        raise ConfigError("iir_group_delay(), coefficients must be non-empty")
    if fc < -0.5 or fc > 0.5:
        raise ConfigError("iir_group_delay(), fc must be in [-0.5,0.5]")
    c = np.convolve(b, a[::-1])
    i = np.arange(len(c))
    e = c * np.exp(2j * np.pi * fc * i)
    t1 = np.sum(e)
    if abs(t1) < 1e-5:
        return 0.0  # reference returns 0 at a response null (mod.rs:809-812)
    return float((np.sum(e * i) / t1).real) - (len(a) - 1)


def iir_design_pll_active_lag(w: float, zeta: float, k: float):
    """2nd-order PLL loop filter, active lag (pll.rs:16)."""
    if w <= 0.0:
        raise ConfigError("bandwidth must be greater than 0")
    if zeta <= 0.0:
        raise ConfigError("damping factor must be greater than 0")
    if k <= 0.0:
        raise ConfigError("gain must be greater than 0")
    t1 = k / (w * w)
    t2 = 2.0 * zeta / w - 1.0 / k
    b = np.array([2 * k * (1 + t2 / 2), 4 * k, 2 * k * (1 - t2 / 2)])
    a = np.array([1 + t1 / 2, -t1, -1 + t1 / 2])
    return b, a


def iir_design_pll_active_pi(w: float, zeta: float, k: float):
    """2nd-order PLL loop filter, active PI (pll.rs:54)."""
    if w <= 0.0:
        raise ConfigError("bandwidth must be greater than 0")
    if zeta <= 0.0:
        raise ConfigError("damping factor must be greater than 0")
    if k <= 0.0:
        raise ConfigError("gain must be greater than 0")
    t1 = k / (w * w)
    t2 = 2.0 * zeta / w
    b = np.array([2 * k * (1 + t2 / 2), 4 * k, 2 * k * (1 - t2 / 2)])
    a = np.array([t1 / 2, -t1, t1 / 2])
    return b, a
