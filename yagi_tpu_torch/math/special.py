"""Scalar special functions (host-side, float64 NumPy).

Copied from :mod:`yagi_tpu.math.special` (the subset the Kaiser design path
needs): these run once at filter-design time, never on the device, and must
give the same coefficients bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

from ..errors import ValueRangeError

__all__ = [
    "lngammaf",
    "gammaf",
    "lnbesselif",
    "besselif",
    "besseli0f",
    "sincf",
    "nextpow2",
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
