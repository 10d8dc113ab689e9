"""Scalar special functions (host-side, float64 NumPy).

Copied from :mod:`yagi_tpu.math.special` (the reference's math/mod.rs,
bessel.rs, gamma.rs): these run once at design or construction time, never
on the device, and give the same values as yagi_tpu's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

from ..errors import ValueRangeError

__all__ = [
    "lngammaf",
    "gammaf",
    "lnlowergammaf",
    "lowergammaf",
    "lnuppergammaf",
    "uppergammaf",
    "factorialf",
    "lnbesselif",
    "besselif",
    "besseli0f",
    "besseljf",
    "besselj0f",
    "qf",
    "marcumqf",
    "marcumq1f",
    "sincf",
    "nextpow2",
    "nchoosek",
]


def lngammaf(z: float) -> float:
    """log(Gamma(z)) for z > 0 (reference: math/gamma.rs:7)."""
    if z <= 0.0:
        raise ValueRangeError("lngammaf(), undefined for z <= 0")
    return math.lgamma(z)


def gammaf(z: float) -> float:
    """Gamma(z), using the reflection identity for z < 0 (gamma.rs:25)."""
    if z < 0.0:
        s = math.sin(math.pi * z)
        if s == 0.0:
            raise ValueRangeError("gammaf(), divide by zero")
        return math.pi / (gammaf(1.0 - z) * s)
    return math.gamma(z)


def lnlowergammaf(z: float, alpha: float) -> float:
    """log of the lower incomplete gamma function γ(z, α) (gamma.rs:45).

    Series: γ(z,α) = α^z Γ(z) e^{-α} Σ_k α^k / Γ(z+k+1).
    """
    t0 = z * math.log(alpha)
    t1 = lngammaf(z)
    t2 = -alpha
    log_alpha = math.log(alpha)
    acc = 0.0
    tmax = -math.inf
    t_prev = None
    for k in range(1000):
        t = k * log_alpha - lngammaf(z + k + 1.0)
        acc += math.exp(t)
        if k == 0 or t > tmax:
            tmax = t
        if k > 50 and t_prev is not None and t_prev > t and (tmax - t) > 40.0:
            break
        t_prev = t
    return t0 + t1 + t2 + math.log(acc)


def lowergammaf(z: float, alpha: float) -> float:
    return math.exp(lnlowergammaf(z, alpha))


def lnuppergammaf(z: float, alpha: float) -> float:
    return math.log(gammaf(z) - lowergammaf(z, alpha))


def uppergammaf(z: float, alpha: float) -> float:
    return math.exp(lnuppergammaf(z, alpha))


def factorialf(n: int) -> float:
    return abs(gammaf(n + 1.0))


def lnbesselif(nu: float, z: float) -> float:
    """log I_ν(z), modified Bessel fn of the first kind (bessel.rs:9)."""
    if z == 0.0:
        return 0.0 if nu == 0.0 else -math.inf
    if nu == 0.5:
        return 0.5 * math.log(2.0 / (math.pi * z)) + math.log(math.sinh(z))
    if z < 1e-3 * math.sqrt(nu + 1.0):
        return -lngammaf(nu + 1.0) + nu * math.log(0.5 * z)
    t0 = nu * math.log(0.5 * z)
    log_half_z = math.log(0.5 * z)
    y = 0.0
    for k in range(128):
        t = 2.0 * k * log_half_z - lngammaf(k + 1.0) - lngammaf(nu + k + 1.0)
        term = math.exp(t)
        y += term
        if k > 8 and term < 1e-18 * y:
            break
    return t0 + math.log(y)


def besselif(nu: float, z: float) -> float:
    """I_ν(z) (bessel.rs:44)."""
    if z == 0.0:
        return 1.0 if nu == 0.0 else 0.0
    if nu == 0.5:
        return math.sqrt(2.0 / (math.pi * z)) * math.sinh(z)
    if z < 1e-3 * math.sqrt(nu + 1.0):
        return (0.5 * z) ** nu / gammaf(nu + 1.0)
    return math.exp(lnbesselif(nu, z))


def besseli0f(z: float) -> float:
    """I_0(z) (bessel.rs:65)."""
    return besselif(0.0, z)


def besseljf(nu: float, z: float) -> float:
    """J_ν(z), Bessel fn of the first kind (bessel.rs:70)."""
    if z == 0.0:
        return 1.0 if nu == 0.0 else 0.0
    if z < 1e-3 * math.sqrt(nu + 1.0):
        return (0.5 * z) ** nu / gammaf(nu + 1.0)
    abs_nu = abs(nu)
    j = 0.0
    log_z = math.log(z)
    log_2 = math.log(2.0)
    for k in range(256):
        t0 = 2.0 * k + abs_nu
        t = t0 * (log_z - log_2) - lngammaf(k + 1.0) - lngammaf(abs_nu + k + 1.0)
        term = math.exp(t)
        j += term if k % 2 == 0 else -term
        if k > 16 and term < 1e-18:
            break
    return j


def besselj0f(z: float) -> float:
    """J_0(z) (bessel.rs:109)."""
    return besseljf(0.0, abs(z))


def qf(z: float) -> float:
    """Gaussian Q-function (math/mod.rs:25)."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def marcumqf(m: int, alpha: float, beta: float) -> float:
    """Marcum Q approximation [Helstrom:1992] (math/mod.rs:30)."""
    sigma = m + 2.0 * alpha
    x = (beta - alpha - m) / (sigma * sigma)
    return math.erfc(x)


def marcumq1f(alpha: float, beta: float) -> float:
    """Marcum Q (M=1) via Bessel series (math/mod.rs:42)."""
    t0 = math.exp(-0.5 * (alpha * alpha + beta * beta))
    t1 = 1.0
    a_div_b = alpha / beta
    a_mul_b = alpha * beta
    y = 0.0
    for k in range(64):
        y += t1 * besselif(float(k), a_mul_b)
        t1 *= a_div_b
    return t0 * y


def sincf(x):
    """sinc(x) = sin(πx)/(πx), array-capable (math/mod.rs:63)."""
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 1e-12
    xs = np.where(small, 1.0, x)
    out = np.where(small, 1.0, np.sin(np.pi * xs) / (np.pi * xs))
    if out.ndim == 0:
        return float(out)
    return out


def nextpow2(x: int) -> int:
    """ceil(log2(x)) (math/mod.rs:80)."""
    if x <= 0:
        raise ValueRangeError("nextpow2(), input must be greater than zero")
    return int(x - 1).bit_length()


def nchoosek(n: int, k: int) -> float:
    """(n choose k) as float (math/mod.rs:95)."""
    if k > n:
        raise ValueRangeError("nchoosek(): k cannot exceed n")
    if k == 0 or k == n:
        return 1.0
    k = max(k, n - k)
    if n > 12:
        t = lngammaf(n + 1.0) - lngammaf(n - k + 1.0) - lngammaf(k + 1.0)
        return round(math.exp(t))
    return float(math.comb(n, k))
