"""FIR filter design (host-side float64): Kaiser, raised-cosine, root-raised-
cosine, the (root-)Nyquist prototype dispatch for those three shapes, the
filter-length estimators, the PM halfband, the notch, and the frequency
response and group delay of a tap vector.

Copied from :mod:`yagi_tpu.design.fir` (design/kaiser.rs, rcos.rs, rrcos.rs,
pm_halfband.rs, mod.rs), bit for bit. The other prototype shapes (PM, the
flipped-Nyquist family, r/arkaiser, hM3, GMSK) are not ported:
:func:`fir_design_prototype` raises :class:`ConfigError` naming the shape.
"""

from __future__ import annotations

import enum

import numpy as np

from ..errors import ConfigError
from ..math import windows as mwin
from ..math.special import sincf
from ..optim import OptimDirection, Qs1dSearch
from .pm import FirPmWeightType, fir_design_pm

__all__ = [
    "FirFilterShape",
    "fir_design_kaiser",
    "fir_design_notch",
    "kaiser_beta_stopband_attenuation",
    "fir_design_rcos",
    "fir_design_rrcos",
    "fir_design_pm_halfband_ft",
    "fir_design_pm_halfband_stopband_attenuation",
    "fir_design_prototype",
    "estimate_req_filter_len",
    "estimate_req_filter_len_kaiser",
    "estimate_req_filter_stopband_attenuation",
    "estimate_req_filter_transition_bandwidth",
    "freqresponse",
    "fir_group_delay",
]


class FirFilterShape(enum.Enum):
    """(root-)Nyquist prototype shapes (design/mod.rs:41-77)."""

    KAISER = "kaiser"
    PM = "pm"
    RCOS = "rcos"
    FEXP = "fexp"
    FSECH = "fsech"
    FARCSECH = "farcsech"
    ARKAISER = "arkaiser"
    RKAISER = "rkaiser"
    RRCOS = "rrcos"
    HM3 = "hm3"
    GMSKTX = "gmsktx"
    GMSKRX = "gmskrx"
    RFEXP = "rfexp"
    RFSECH = "rfsech"
    RFARCSECH = "rfarcsech"

    @classmethod
    def from_str(cls, s: str) -> "FirFilterShape":
        for shape in cls:
            if shape.value == s:
                return shape
        raise ConfigError(f"unknown filter type {s!r}")


# --------------------------------------------------------------- estimators
def estimate_req_filter_len_kaiser(df: float, as_: float) -> float:
    """Kaiser's length rule [Vaidyanathan:1993] (design/mod.rs:228)."""
    if df > 0.5 or df <= 0.0:
        raise ConfigError(f"transition bandwidth ({df}) out of range (0, 0.5)")
    if as_ <= 0.0:
        raise ConfigError("stopband attenuation must be greater than zero")
    return (as_ - 7.95) / (14.26 * df)


def estimate_req_filter_len(df: float, as_: float) -> int:
    """Filter length from transition bw + attenuation (design/mod.rs:138)."""
    return int(estimate_req_filter_len_kaiser(df, as_))


def estimate_req_filter_stopband_attenuation(df: float, n: int) -> float:
    """Bisection for attenuation given length (design/mod.rs:161)."""
    as0, as1 = 0.01, 200.0
    as_hat = 0.0
    for _ in range(20):
        as_hat = 0.5 * (as1 + as0)
        n_hat = estimate_req_filter_len_kaiser(df, as_hat)
        if n_hat < n:
            as0 = as_hat
        else:
            as1 = as_hat
    return as_hat


def estimate_req_filter_transition_bandwidth(as_: float, n: int) -> float:
    """Bisection for transition bw given length (design/mod.rs:193)."""
    df0, df1 = 1e-3, 0.499
    df_hat = 0.0
    for _ in range(20):
        df_hat = 0.5 * (df1 + df0)
        n_hat = estimate_req_filter_len_kaiser(df_hat, as_)
        if n_hat < n:
            df1 = df_hat
        else:
            df0 = df_hat
    return df_hat


# ------------------------------------------------------------ basic designs
def kaiser_beta_stopband_attenuation(as_: float) -> float:
    """Kaiser beta from stop-band attenuation (design/kaiser.rs:62)."""
    as_abs = abs(as_)
    if as_abs > 50.0:
        return 0.1102 * (as_abs - 8.7)
    if as_abs > 21.0:
        return 0.5842 * (as_abs - 21.0) ** 0.4 + 0.07886 * (as_abs - 21.0)
    return 0.0


def fir_design_kaiser(n: int, fc: float, as_: float, mu: float = 0.0) -> np.ndarray:
    """Kaiser windowed-sinc lowpass (design/kaiser.rs:16)."""
    if mu <= -0.5 or mu > 0.5:
        raise ConfigError(f"fractional sample offset ({mu}) out of range (-0.5, 0.5)")
    if fc <= 0.0 or fc > 0.5:
        raise ConfigError(f"cutoff frequency ({fc}) out of range (0, 0.5)")
    if n == 0:
        raise ConfigError("filter length must be greater than zero")
    if as_ <= 0.0:
        raise ConfigError("stop-band attenuation must be greater than zero")
    beta = kaiser_beta_stopband_attenuation(as_)
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0 + mu
    return sincf(2.0 * fc * t) * mwin.kaiser(n, beta)


def fir_design_notch(m: int, f0: float, as_: float) -> np.ndarray:
    """FIR notch filter (design/mod.rs:336)."""
    if m < 1 or m > 1000:
        raise ConfigError(f"filter semi-length ({m}) out of range [1,1000]")
    if f0 < -0.5 or f0 > 0.5:
        raise ConfigError(f"notch frequency ({f0}) out of range [-0.5,0.5]")
    if as_ <= 0.0:
        raise ConfigError("stop-band attenuation must be greater than zero")
    n = 2 * m + 1
    beta = kaiser_beta_stopband_attenuation(as_)
    i = np.arange(n, dtype=np.float64)
    p = -np.cos(2.0 * np.pi * f0 * (i - m))
    w = mwin.kaiser(n, beta)
    h = p * w
    h = h / np.sum(h * p)
    h[m] += 1.0
    return h


# ----------------------------------------------------------- Nyquist shapes
def _validate_km_beta(k: int, m: int, beta: float) -> None:
    if k < 1:
        raise ConfigError("k must be greater than 0")
    if m < 1:
        raise ConfigError("m must be greater than 0")
    if beta < 0.0 or beta > 1.0:
        raise ConfigError("beta must be in [0,1]")


def fir_design_rcos(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Raised-cosine Nyquist filter (design/rcos.rs:17)."""
    _validate_km_beta(k, m, beta)
    n = np.arange(2 * k * m + 1, dtype=np.float64)
    z = (n + dt) / k - m
    t1 = np.cos(beta * np.pi * z)
    t2 = sincf(z)
    t3 = 1.0 - 4.0 * beta * beta * z * z
    special = np.abs(t3) < 1e-3
    h = np.where(
        special,
        np.sin(np.pi / (2.0 * beta)) * beta * 0.5 if beta > 0 else 1.0,
        t1 * t2 / np.where(special, 1.0, t3),
    )
    return h


def fir_design_rrcos(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Root-raised-cosine filter (design/rrcos.rs:15)."""
    _validate_km_beta(k, m, beta)
    n = np.arange(2 * k * m + 1, dtype=np.float64)
    z = (n + dt) / k - m
    h = np.empty_like(z)
    for i, zi in enumerate(z):
        if abs(zi) < 1e-5:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        else:
            g = (1.0 - 16.0 * beta * beta * zi * zi) ** 2
            if abs(g) < 1e-5:
                g1 = 1.0 + 2.0 / np.pi
                g2 = np.sin(0.25 * np.pi / beta)
                g3 = 1.0 - 2.0 / np.pi
                g4 = np.cos(0.25 * np.pi / beta)
                h[i] = beta / np.sqrt(2.0) * (g1 * g2 + g3 * g4)
            else:
                t1 = np.cos((1.0 + beta) * np.pi * zi)
                t2 = np.sin((1.0 - beta) * np.pi * zi)
                t3 = 1.0 / (4.0 * beta * zi)
                t4 = 4.0 * beta / (np.pi * (1.0 - 16.0 * beta * beta * zi * zi))
                h[i] = t4 * (t1 + t2 * t3)
    return h


# PM halfband (design/pm_halfband.rs)
def fir_design_pm_halfband_ft(m: int, ft: float) -> np.ndarray:
    """PM halfband given transition band, optimizing stop-band power
    with a qs1d search over the lower band edge (pm_halfband.rs:100)."""
    h_len = 4 * m + 1
    nfft = 1200
    while nfft < 20 * m:
        nfft <<= 1
    n_eval = int(nfft * (0.25 - 0.5 * ft))
    state = {"h": np.zeros(h_len)}

    def utility(gamma: float) -> float:
        f0 = 0.25 - 0.5 * ft * gamma
        f1 = 0.25 + 0.5 * ft
        h = fir_design_pm(
            h_len,
            [0.0, f0, f1, 0.5],
            [1.0, 0.0],
            [1.0, 1.0],
            [FirPmWeightType.FLAT, FirPmWeightType.FLAT],
        )
        # force exact zeros on even-index outer coefficients; the reference
        # stores (and returns) the zero-forced version (pm_halfband.rs:62-66)
        hh = h.copy()
        for i in range(m):
            hh[2 * i] = 0.0
            hh[h_len - 2 * i - 1] = 0.0
        state["h"] = hh
        H = np.fft.fft(hh, nfft)
        idx = nfft // 2 - np.arange(n_eval)
        u = np.sum(np.abs(H[idx]) ** 2)
        return float(10.0 * np.log10(u / n_eval))

    search = Qs1dSearch(utility, OptimDirection.MINIMIZE)
    search.init_bounds(1.0, 0.9)
    for _ in range(32):
        search.step()
    return state["h"]


def fir_design_pm_halfband_stopband_attenuation(m: int, as_: float) -> np.ndarray:
    """PM halfband given stop-band suppression (pm_halfband.rs:130)."""
    ft = estimate_req_filter_transition_bandwidth(as_, 4 * m + 1)
    return fir_design_pm_halfband_ft(m, ft)


# ------------------------------------------------------- prototype dispatch
def fir_design_prototype(
    ftype: FirFilterShape, k: int, m: int, beta: float, dt: float = 0.0
) -> np.ndarray:
    """(root-)Nyquist prototype dispatch (design/mod.rs:392) for the KAISER,
    RCOS and RRCOS shapes; any other shape raises :class:`ConfigError`."""
    if ftype == FirFilterShape.KAISER:
        h_len = 2 * k * m + 1
        as_ = estimate_req_filter_stopband_attenuation(beta / k, h_len)
        return fir_design_kaiser(h_len, 0.5 / k, as_, dt)
    if ftype == FirFilterShape.RCOS:
        return fir_design_rcos(k, m, beta, dt)
    if ftype == FirFilterShape.RRCOS:
        return fir_design_rrcos(k, m, beta, dt)
    raise ConfigError(f"prototype shape {ftype.value!r} is not ported; use kaiser, rcos or rrcos")


# ---------------------------------------------------------------- analysis
def freqresponse(h, fc: float) -> complex:
    """Frequency response at fc (design/mod.rs:666)."""
    h = np.asarray(h)
    i = np.arange(len(h), dtype=np.float64)
    ejwt = np.exp(-2j * np.pi * float(fc) * i)
    return complex(np.sum(h * ejwt))


def fir_group_delay(h, fc: float) -> float:
    """FIR group delay at fc (design/mod.rs:687)."""
    h = np.asarray(h, dtype=np.float64)
    if len(h) == 0:
        raise ConfigError("fir_group_delay(), length must be greater than zero")
    if fc < -0.5 or fc > 0.5:
        raise ConfigError("fir_group_delay(), fc must be in [-0.5,0.5]")
    i = np.arange(len(h), dtype=np.float64)
    ejwt = np.exp(2j * np.pi * fc * i)
    t0 = np.sum(h * ejwt * i)
    t1 = np.sum(h * ejwt)
    return float((t0 / t1).real)
