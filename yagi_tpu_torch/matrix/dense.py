"""Dense matrix operations, host-side NumPy.

Copied from :mod:`yagi_tpu.matrix.dense` (the reference's matrix/{math,
ludecomp,qrdecomp,chol,inv,linsolve,cgsolve,gramschmidt}.rs): 2-D NumPy
arrays in, the decompositions in float64 (Crout/Doolittle LU, Gram-Schmidt
QR) as yagi_tpu promotes, validated against the reference's matrix golden
fixtures.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = [
    "matrix_add", "matrix_sub", "matrix_mul", "matrix_aug",
    "matrix_det", "matrix_trans", "matrix_hermitian",
    "matrix_transmul", "matrix_mul_transpose", "matrix_mul_hermitian",
    "matrix_inv", "matrix_ludecomp_crout", "matrix_ludecomp_doolittle",
    "matrix_qrdecomp_gramschmidt", "matrix_chol", "matrix_linsolve",
    "matrix_cgsolve", "matrix_gramschmidt",
]


def _as2d(x):
    a = np.asarray(x)
    if a.ndim != 2:
        raise ConfigError("matrix must be 2-D")
    return a


def matrix_add(a, b):
    """Element-wise add (math.rs:13)."""
    a, b = _as2d(a), _as2d(b)
    if a.shape != b.shape:
        raise ConfigError("matrix dimensions must match")
    return a + b


def matrix_sub(a, b):
    a, b = _as2d(a), _as2d(b)
    if a.shape != b.shape:
        raise ConfigError("matrix dimensions must match")
    return a - b


def matrix_mul(a, b):
    """Matrix product (math.rs)."""
    a, b = _as2d(a), _as2d(b)
    if a.shape[1] != b.shape[0]:
        raise ConfigError("inner matrix dimensions must match")
    return a @ b


def matrix_aug(a, b):
    """Horizontal augmentation [A | B] (math.rs)."""
    a, b = _as2d(a), _as2d(b)
    if a.shape[0] != b.shape[0]:
        raise ConfigError("row dimensions must match")
    return np.concatenate([a, b], axis=1)


def matrix_det(a):
    """Determinant (math.rs, via LU in the reference)."""
    a = _as2d(a)
    if a.shape[0] != a.shape[1]:
        raise ConfigError("matrix must be square")
    return np.linalg.det(a)


def matrix_trans(a):
    """Transpose (math.rs)."""
    return _as2d(a).T.copy()


def matrix_hermitian(a):
    """Conjugate transpose (math.rs)."""
    return _as2d(a).conj().T.copy()


def matrix_transmul(a):
    """Aᵀ·A (math.rs transmul)."""
    a = _as2d(a)
    return a.T @ a


def matrix_mul_transpose(a):
    """A·Aᵀ (math.rs)."""
    a = _as2d(a)
    return a @ a.T


def matrix_mul_hermitian(a):
    """A·Aᴴ (math.rs)."""
    a = _as2d(a)
    return a @ a.conj().T


def matrix_inv(a):
    """Inverse via Gauss-Jordan (inv.rs:6,48)."""
    a = _as2d(a)
    if a.shape[0] != a.shape[1]:
        raise ConfigError("matrix must be square")
    return np.linalg.inv(a)


def matrix_ludecomp_crout(a):
    """Crout LU: A = L·U with U having unit diagonal (ludecomp.rs:5)."""
    a = _as2d(a).astype(np.result_type(a, np.float64))
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ConfigError("matrix must be square")
    L = np.zeros_like(a)
    U = np.eye(n, dtype=a.dtype)
    for j in range(n):
        for i in range(j, n):
            L[i, j] = a[i, j] - L[i, :j] @ U[:j, j]
        for i in range(j + 1, n):
            U[j, i] = (a[j, i] - L[j, :j] @ U[:j, i]) / L[j, j]
    return L, U


def matrix_ludecomp_doolittle(a):
    """Doolittle LU: A = L·U with L having unit diagonal (ludecomp.rs:53)."""
    a = _as2d(a).astype(np.result_type(a, np.float64))
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ConfigError("matrix must be square")
    L = np.eye(n, dtype=a.dtype)
    U = np.zeros_like(a)
    for i in range(n):
        for j in range(i, n):
            U[i, j] = a[i, j] - L[i, :i] @ U[:i, j]
        for j in range(i + 1, n):
            L[j, i] = (a[j, i] - L[j, :i] @ U[:i, i]) / U[i, i]
    return L, U


def matrix_qrdecomp_gramschmidt(a):
    """QR via classical Gram-Schmidt (qrdecomp.rs:8)."""
    a = _as2d(a).astype(np.result_type(a, np.float64))
    m, n = a.shape
    Q = np.zeros_like(a)
    R = np.zeros((n, n), dtype=a.dtype)
    for j in range(n):
        v = a[:, j].copy()
        for i in range(j):
            R[i, j] = np.vdot(Q[:, i], a[:, j])
            v -= R[i, j] * Q[:, i]
        R[j, j] = np.linalg.norm(v)
        Q[:, j] = v / R[j, j]
    return Q, R


def matrix_chol(a):
    """Cholesky A = L·Lᴴ (chol.rs:11)."""
    a = _as2d(a)
    if a.shape[0] != a.shape[1]:
        raise ConfigError("matrix must be square")
    return np.linalg.cholesky(a)


def matrix_linsolve(a, b):
    """Solve A·x = b (linsolve.rs:17)."""
    a = _as2d(a)
    b = np.asarray(b)
    return np.linalg.solve(a, b)


def matrix_cgsolve(a, b, max_iters: int | None = None, tol: float = 1e-6):
    """Conjugate-gradient solve for symmetric positive definite A
    (cgsolve.rs:15)."""
    a = _as2d(a).astype(np.float64)
    b = np.asarray(b, dtype=np.float64).ravel()
    n = len(b)
    if max_iters is None:
        max_iters = 4 * n
    x = np.zeros(n)
    r = b - a @ x
    p = r.copy()
    rs_old = r @ r
    for _ in range(max_iters):
        ap = a @ p
        alpha = rs_old / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        if np.sqrt(rs_new) < tol:
            break
        p = r + (rs_new / rs_old) * p
        rs_old = rs_new
    return x


def matrix_gramschmidt(a):
    """Orthonormalize columns (gramschmidt.rs:8,35)."""
    Q, _ = matrix_qrdecomp_gramschmidt(a)
    return Q
