"""Polynomial utilities (host-side, float64/complex128 NumPy).

Copied from :mod:`yagi_tpu.math.poly` (poly.rs), bit for bit: the IIR design
math (:mod:`..design.iir`) needs the binomial expansions, the product of
roots and the root finder. Coefficient convention is
*ascending* powers: ``P(x) = p[0] + p[1] x + ... + p[n] x^n`` (poly.rs:20-37).
Root finding uses an eigenvalue companion-matrix solve (numerically at least
as robust as the reference's Durand-Kerner / Bairstow drivers, poly.rs:419,503)
plus liquid's root sort order (poly.rs:686).
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = [
    "poly_val",
    "poly_fit",
    "poly_expandbinomial",
    "poly_expandbinomial_pm",
    "poly_expandroots",
    "poly_expandroots2",
    "poly_mul",
    "poly_interp_lagrange",
    "poly_fit_lagrange",
    "poly_fit_lagrange_barycentric",
    "poly_val_lagrange_barycentric",
    "poly_findroots",
    "poly_findroots_durandkerner",
]


def poly_val(p, x):
    """Evaluate P(x) = Σ p[i] x^i (poly.rs:20)."""
    p = np.asarray(p)
    y = np.zeros_like(np.asarray(x) * p[0])
    xk = np.ones_like(y)
    for c in p:
        y = y + c * xk
        xk = xk * x
    return y


def poly_fit(x, y, k: int):
    """Least-squares fit of a (k-1)-degree polynomial (poly.rs:46).

    Returns ascending coefficients of length k.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) != len(y):
        raise ConfigError("poly_fit: x and y must have equal length")
    # Vandermonde with ascending powers; lstsq for robustness.
    A = np.vander(x, k, increasing=True)
    p, *_ = np.linalg.lstsq(A, y, rcond=None)
    return p


def poly_expandbinomial(n: int):
    """(1+x)^n → ascending coefficients, length n+1 (poly.rs:93)."""
    if n == 0:
        return np.zeros(1)
    c = np.zeros(n + 1)
    c[0] = 1.0
    for _ in range(n):
        c[1 : n + 1] += c[0:n].copy()
    return c


def poly_expandbinomial_pm(m: int, k: int):
    """(1+x)^m (1-x)^k → ascending coefficients (poly.rs:126)."""
    a = poly_expandbinomial(m) if m > 0 else np.array([1.0])
    # (1-x)^k
    b = np.array([1.0])
    for _ in range(k):
        b = np.convolve(b, np.array([1.0, -1.0]))
    c = np.convolve(a, b)
    n = m + k
    return c[: n + 1]


def poly_expandroots(r):
    """∏ (x - r[i]) → ascending coefficients (poly.rs:169)."""
    r = np.asarray(r)
    n = len(r)
    if n == 0:
        return np.zeros(1, dtype=r.dtype if r.size else np.float64)
    p = np.zeros(n + 1, dtype=np.result_type(r.dtype, np.float64))
    p[0] = 1.0
    for i in range(n):
        p[1 : i + 2] = -r[i] * p[1 : i + 2] + p[0 : i + 1]
        p[0] = -r[i] * p[0]
    return p


def poly_expandroots2(a, b):
    """∏ (b[i] x - a[i]) → ascending coefficients (poly.rs:204)."""
    a = np.asarray(a)
    b = np.asarray(b)
    p = np.array([1.0], dtype=np.result_type(a.dtype, b.dtype, np.float64))
    for ai, bi in zip(a, b):
        p = np.convolve(p, np.array([-ai, bi]))
    return p


def poly_mul(a, b):
    """Polynomial product in ascending-coefficient form (poly.rs:241)."""
    return np.convolve(np.asarray(a), np.asarray(b))


def poly_interp_lagrange(x, y, x0):
    """Direct Lagrange interpolation at x0 (poly.rs:272)."""
    x = np.asarray(x)
    y = np.asarray(y)
    n = len(x)
    y0 = 0.0
    for i in range(n):
        g = 1.0
        for j in range(n):
            if i != j:
                g = g * (x0 - x[j]) / (x[i] - x[j])
        y0 = y0 + y[i] * g
    return y0


def poly_fit_lagrange(x, y):
    """Exact polynomial through n points, ascending coefficients (poly.rs:304)."""
    x = np.asarray(x)
    y = np.asarray(y)
    n = len(x)
    p = np.zeros(n, dtype=np.result_type(x.dtype, y.dtype, np.float64))
    for i in range(n):
        others = np.delete(x, i)
        num = poly_expandroots(others)
        den = np.prod(x[i] - others)
        p = p + y[i] * num / den
    return p


def poly_fit_lagrange_barycentric(x):
    """Barycentric weights for nodes x (poly.rs:347)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    w = np.ones(n)
    for i in range(n):
        for j in range(n):
            if i != j:
                w[i] /= x[i] - x[j]
    # normalize by w[0] as liquid does
    return w / w[0]


def poly_val_lagrange_barycentric(x, y, w, x0):
    """Barycentric Lagrange evaluation (poly.rs:385)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    diff = x0 - x
    hit = np.isclose(diff, 0.0, atol=1e-12)
    if np.any(hit):
        return float(y[np.argmax(hit)])
    t = w / diff
    return float(np.sum(t * y) / np.sum(t))


def _sort_roots(roots: np.ndarray) -> np.ndarray:
    """liquid's root ordering (poly.rs:686): real ascending, imag descending."""
    re = roots.real + 0.0  # normalize -0.0 → 0.0
    order = np.lexsort((-roots.imag, re))
    return roots[order]


def poly_findroots(p):
    """Roots of P(x) = Σ p[i] x^i, ascending coefficients (poly.rs:716).

    Uses the companion-matrix eigenvalue method; returns liquid-sorted roots.
    """
    p = np.asarray(p, dtype=np.complex128)
    if len(p) < 2:
        raise ConfigError("poly_findroots: polynomial order must be > 0")
    if p[-1] == 0:
        raise ConfigError("poly_findroots: leading coefficient must be non-zero")
    # np.roots takes descending coefficients
    r = np.roots(p[::-1])
    return _sort_roots(np.asarray(r, dtype=np.complex128))


def poly_findroots_durandkerner(p, max_iters: int = 100, tol: float = 1e-12):
    """Durand-Kerner simultaneous iteration (poly.rs:419), kept for parity."""
    p = np.asarray(p, dtype=np.complex128)
    n = len(p) - 1
    pn = p / p[-1]
    # standard initialization on a spiral
    r = (0.4 + 0.9j) ** np.arange(n)
    for _ in range(max_iters):
        delta = np.zeros_like(r)
        for i in range(n):
            num = poly_val(pn, r[i])
            den = np.prod(r[i] - np.delete(r, i))
            delta[i] = num / den
        r = r - delta
        if np.max(np.abs(delta)) < tol:
            break
    return _sort_roots(r)
