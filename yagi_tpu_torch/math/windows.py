"""Tapering windows (host-side, float64 NumPy).

Copied from :mod:`yagi_tpu.math.windows`: the Kaiser window, the one the
Kaiser FIR design needs.
"""

from __future__ import annotations

import numpy as np

from ..errors import ValueRangeError
from .special import besseli0f

__all__ = ["kaiser"]


def _check_len(wlen: int) -> None:
    if wlen <= 0:
        raise ValueRangeError("window length must be greater than zero")


def kaiser(wlen: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel window (windows.rs:76)."""
    _check_len(wlen)
    if beta < 0.0:
        raise ValueRangeError("kaiser window beta must be >= 0")
    i = np.arange(wlen, dtype=np.float64)
    if wlen == 1:
        return np.ones(1)
    t = i - (wlen - 1) / 2.0
    r = 2.0 * t / (wlen - 1)
    b = besseli0f(beta)
    a = np.array([besseli0f(beta * np.sqrt(max(1.0 - ri * ri, 0.0))) for ri in r])
    return a / b
