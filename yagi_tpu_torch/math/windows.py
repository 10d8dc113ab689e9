"""Tapering window functions (host-side, float64 NumPy).

Copied from :mod:`yagi_tpu.math.windows` (behavioral spec: the reference's
math/windows.rs). The reference computes windows point by point,
``window(type, i, wlen, arg)``; here each function returns the whole
length-``wlen`` vector at once (design-time code), and :func:`window_at`
gives the point-wise form.
"""

from __future__ import annotations

import enum

import numpy as np

from ..errors import ConfigError, ValueRangeError
from .special import besseli0f

__all__ = [
    "WindowType",
    "window",
    "window_at",
    "hamming",
    "hann",
    "blackman_harris",
    "blackman_harris7",
    "kaiser",
    "flat_top",
    "triangular",
    "rcos_taper",
    "kbd",
    "kbd_window",
    "get_window_type",
]


class WindowType(enum.Enum):
    """Window taxonomy (windows.rs:7-18)."""

    UNKNOWN = "unknown"
    HAMMING = "hamming"
    HANN = "hann"
    BLACKMAN_HARRIS = "blackmanharris"
    BLACKMAN_HARRIS7 = "blackmanharris7"
    KAISER = "kaiser"
    FLAT_TOP = "flattop"
    TRIANGULAR = "triangular"
    RCOS_TAPER = "rcostaper"
    KBD = "kbd"


def get_window_type(name: str) -> WindowType:
    """String → WindowType (windows.rs:50)."""
    for wt in WindowType:
        if wt.value == name:
            return wt
    raise ConfigError(f"unknown window type {name!r}")


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


def hamming(wlen: int) -> np.ndarray:
    """Hamming window, liquid's 0.53836/0.46164 coefficients (windows.rs:92)."""
    _check_len(wlen)
    i = np.arange(wlen, dtype=np.float64)
    return 0.53836 - 0.46164 * np.cos(2.0 * np.pi * i / (wlen - 1))


def hann(wlen: int) -> np.ndarray:
    """Hann window (windows.rs:100)."""
    _check_len(wlen)
    i = np.arange(wlen, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (wlen - 1))


def blackman_harris(wlen: int) -> np.ndarray:
    """4-term Blackman-Harris (windows.rs:108)."""
    _check_len(wlen)
    t = 2.0 * np.pi * np.arange(wlen, dtype=np.float64) / (wlen - 1)
    return (
        0.35875
        - 0.48829 * np.cos(t)
        + 0.14128 * np.cos(2 * t)
        - 0.01168 * np.cos(3 * t)
    )


def blackman_harris7(wlen: int) -> np.ndarray:
    """7-term Blackman-Harris (windows.rs:122)."""
    _check_len(wlen)
    t = 2.0 * np.pi * np.arange(wlen, dtype=np.float64) / (wlen - 1)
    a = [0.27105, 0.43329, 0.21812, 0.06592, 0.01081, 0.00077, 0.00001]
    w = np.full(wlen, a[0])
    for k in range(1, 7):
        w += ((-1) ** k) * a[k] * np.cos(k * t)
    return w


def flat_top(wlen: int) -> np.ndarray:
    """Flat-top window (windows.rs:140)."""
    _check_len(wlen)
    t = 2.0 * np.pi * np.arange(wlen, dtype=np.float64) / (wlen - 1)
    return (
        1.000
        - 1.930 * np.cos(t)
        + 1.290 * np.cos(2 * t)
        - 0.388 * np.cos(3 * t)
        + 0.028 * np.cos(4 * t)
    )


def triangular(wlen: int, n: int) -> np.ndarray:
    """Triangular window with sub-length n ∈ wlen+{-1,0,1} (windows.rs:155)."""
    _check_len(wlen)
    if n not in (wlen - 1, wlen, wlen + 1):
        raise ValueRangeError("triangular window sub-length must be in wlen+{-1,0,1}")
    if n == 0:
        raise ValueRangeError("triangular window sub-length must be greater than zero")
    i = np.arange(wlen, dtype=np.float64)
    v0 = i - (wlen - 1) / 2.0
    v1 = n / 2.0
    return 1.0 - np.abs(v0 / v1)


def rcos_taper(wlen: int, t: int) -> np.ndarray:
    """Raised-cosine tapered rectangular window (windows.rs:171)."""
    _check_len(wlen)
    if t > wlen // 2:
        raise ValueRangeError("rcos taper length cannot exceed half window length")
    i = np.arange(wlen)
    j = np.where(i > wlen - t - 1, wlen - i - 1, i)
    w = np.ones(wlen, dtype=np.float64)
    mask = j < t
    w[mask] = 0.5 - 0.5 * np.cos(np.pi * (j[mask] + 0.5) / t)
    return w


def kbd_window(wlen: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel-derived window (windows.rs:217)."""
    if wlen <= 0:
        raise ValueRangeError("KBD window length must be greater than zero")
    if wlen % 2 != 0:
        raise ValueRangeError("KBD window length must be even")
    if beta < 0.0:
        raise ValueRangeError("KBD window beta must be positive")
    m = wlen // 2
    wk = kaiser(m + 1, beta)
    w_sum = wk.sum()
    w = np.zeros(wlen, dtype=np.float64)
    w_acc = np.cumsum(wk[:m])
    w[:m] = np.sqrt(w_acc / w_sum)
    w[m:] = w[:m][::-1]
    return w


def kbd(i: int, wlen: int, beta: float):
    """Point-wise KBD window sample (windows.rs:188)."""
    if i >= wlen:
        raise ValueRangeError("KBD window index exceeds maximum")
    return float(kbd_window(wlen, beta)[i])


_WINDOW_FNS = {
    WindowType.HAMMING: lambda wlen, arg: hamming(wlen),
    WindowType.HANN: lambda wlen, arg: hann(wlen),
    WindowType.BLACKMAN_HARRIS: lambda wlen, arg: blackman_harris(wlen),
    WindowType.BLACKMAN_HARRIS7: lambda wlen, arg: blackman_harris7(wlen),
    WindowType.KAISER: kaiser,
    WindowType.FLAT_TOP: lambda wlen, arg: flat_top(wlen),
    WindowType.TRIANGULAR: lambda wlen, arg: triangular(wlen, int(arg)),
    WindowType.RCOS_TAPER: lambda wlen, arg: rcos_taper(wlen, int(arg)),
    WindowType.KBD: kbd_window,
}


def window(window_type: WindowType, wlen: int, arg: float = 0.0) -> np.ndarray:
    """Full window vector by type (windows.rs:60 dispatch)."""
    if window_type not in _WINDOW_FNS:
        raise ConfigError("unknown window type")
    return _WINDOW_FNS[window_type](wlen, arg)


def window_at(window_type: WindowType, i: int, wlen: int, arg: float = 0.0) -> float:
    """Point-wise window sample, parity with reference signature."""
    if i >= wlen:
        raise ValueRangeError("window sample index must not exceed window length")
    return float(window(window_type, wlen, arg)[i])
