"""FIR filter design (host-side float64).

Copied from :mod:`yagi_tpu.design.fir` (design/kaiser.rs, rcos.rs,
rrcos.rs, rkaiser.rs, fnyquist.rs, gmsk.rs, hm3.rs, pm_halfband.rs,
mod.rs): every function returns numpy coefficients equal to yagi_tpu's bit
for bit; the streaming objects move them to their device when they are
built.
"""

from __future__ import annotations

import enum

import numpy as np

from ..errors import ConfigError
from ..math.special import besselj0f, nextpow2, qf, sincf
from ..math import windows as mwin
from ..optim import OptimDirection, Qs1dSearch
from .pm import FirPmBandType, FirPmWeightType, fir_design_pm

__all__ = [
    "FirFilterShape",
    "fir_design_kaiser",
    "kaiser_beta_stopband_attenuation",
    "fir_design_windowf",
    "fir_design_notch",
    "fir_design_dc_blocker",
    "fir_design_doppler",
    "fir_design_rcos",
    "fir_design_rrcos",
    "fir_design_rkaiser",
    "fir_design_arkaiser",
    "fir_design_fexp",
    "fir_design_rfexp",
    "fir_design_fsech",
    "fir_design_rfsech",
    "fir_design_farcsech",
    "fir_design_rfarcsech",
    "fir_design_gmsktx",
    "fir_design_gmskrx",
    "fir_design_hm3",
    "fir_design_pm_halfband_ft",
    "fir_design_pm_halfband_stopband_attenuation",
    "fir_design_prototype",
    "estimate_req_filter_len",
    "estimate_req_filter_len_kaiser",
    "estimate_req_filter_len_herrmann",
    "estimate_req_filter_stopband_attenuation",
    "estimate_req_filter_transition_bandwidth",
    "filter_autocorr",
    "filter_crosscorr",
    "filter_isi",
    "filter_energy",
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


def estimate_req_filter_len_herrmann(df: float, as_: float) -> float:
    """Herrmann's length rule [Herrmann:1973] (design/mod.rs:250)."""
    if df > 0.5 or df <= 0.0:
        raise ConfigError(f"transition bandwidth ({df}) out of range (0, 0.5)")
    if as_ <= 0.0:
        raise ConfigError("stopband attenuation must be greater than zero")
    if as_ > 105.0:
        return estimate_req_filter_len_kaiser(df, as_)
    as_ = as_ + 7.4
    d1 = 10.0 ** (-as_ / 20.0)
    t1 = t2 = np.log10(d1)
    dinf = (0.005309 * t1 * t1 + 0.07114 * t1 - 0.4761) * t2 - (
        0.002660 * t1 * t1 + 0.59410 * t1 + 0.4278
    )
    f = 11.012 + 0.51244 * (t1 - t2)
    return (dinf - f * df * df) / df + 1.0


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


def fir_design_windowf(
    wtype: mwin.WindowType, n: int, fc: float, arg: float = 0.0
) -> np.ndarray:
    """Generic windowed-sinc design (design/mod.rs:298)."""
    if fc <= 0.0 or fc > 0.5:
        raise ConfigError(f"cutoff frequency ({fc}) out of range (0, 0.5)")
    if n == 0:
        raise ConfigError("filter length must be greater than zero")
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    return sincf(2.0 * fc * t) * mwin.window(wtype, n, arg)


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


def fir_design_dc_blocker(m: int, as_: float) -> np.ndarray:
    """DC-blocking filter = notch at f0=0 (firfilt.rs:166)."""
    return fir_design_notch(m, 0.0, as_)


def fir_design_doppler(n: int, fd: float, k: float, theta: float) -> np.ndarray:
    """Jakes/Rice doppler filter (design/mod.rs:464)."""
    beta = 4.0
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    j = 1.5 * np.array([besselj0f(abs(2.0 * np.pi * fd * ti)) for ti in t])
    r = 1.5 * k / (k + 1.0) * np.cos(2.0 * np.pi * fd * t * np.cos(theta))
    w = mwin.kaiser(n, beta)
    return (j + r) * w


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


# flipped-Nyquist family (design/fnyquist.rs)
def _asech(z: np.ndarray) -> np.ndarray:
    out = np.zeros_like(z)
    ok = (z > 0.0) & (z <= 1.0)
    zi = 1.0 / np.where(ok, z, 1.0)
    out = np.where(ok, np.log(np.sqrt(zi - 1.0) * np.sqrt(zi + 1.0) + zi), 0.0)
    return out


def _fnyquist_freqresponse(shape: str, k: int, beta: float, h_len: int) -> np.ndarray:
    f0 = 0.5 * (1.0 - beta) / k
    f1 = 0.5 / k
    f2 = 0.5 * (1.0 + beta) / k
    b = 0.5 / k
    i = np.arange(h_len, dtype=np.float64)
    f = i / h_len
    f = np.where(f > 0.5, f - 1.0, f)
    f = np.abs(f)

    H = np.zeros(h_len)
    passband = f < f0
    trans_lo = (f > f0) & (f < f1)
    trans_hi = (f >= f1) & (f < f2)
    H[passband] = 1.0
    if shape == "fexp":
        gamma = np.log(2.0) / (beta * b)
        H[trans_lo] = np.exp(gamma * (b * (1.0 - beta) - f[trans_lo]))
        H[trans_hi] = 1.0 - np.exp(gamma * (f[trans_hi] - (1.0 + beta) * b))
    elif shape == "fsech":
        gamma = np.log(np.sqrt(3.0) + 2.0) / (beta * b)
        H[trans_lo] = 1.0 / np.cosh(gamma * (f[trans_lo] - b * (1.0 - beta)))
        H[trans_hi] = 1.0 - 1.0 / np.cosh(gamma * (b * (1.0 + beta) - f[trans_hi]))
    elif shape == "farcsech":
        gamma = np.log(np.sqrt(3.0) + 2.0) / (beta * b)
        zeta = 1.0 / (2.0 * beta * b)
        H[trans_lo] = 1.0 - (zeta / gamma) * _asech(
            zeta * (b * (1.0 + beta) - f[trans_lo])
        )
        H[trans_hi] = (zeta / gamma) * _asech(zeta * (f[trans_hi] - b * (1.0 - beta)))
    else:
        raise ConfigError(f"unsupported fnyquist shape {shape}")
    return H


def _fir_design_fnyquist(shape: str, root: bool, k: int, m: int, beta: float) -> np.ndarray:
    """Frequency-sampled (root-)Nyquist design (design/fnyquist.rs:28)."""
    _validate_km_beta(k, m, beta)
    h_len = 2 * k * m + 1
    H = _fnyquist_freqresponse(shape, k, beta, h_len)
    if root:
        H = np.sqrt(H)
    # unnormalized inverse transform (liquid backward convention)
    h_time = np.fft.ifft(H) * h_len
    idx = (np.arange(h_len) + k * m + 1) % h_len
    return (h_time[idx].real * k / h_len).astype(np.float64)


def fir_design_fexp(k, m, beta, dt=0.0):
    return _fir_design_fnyquist("fexp", False, k, m, beta)


def fir_design_rfexp(k, m, beta, dt=0.0):
    return _fir_design_fnyquist("fexp", True, k, m, beta)


def fir_design_fsech(k, m, beta, dt=0.0):
    return _fir_design_fnyquist("fsech", False, k, m, beta)


def fir_design_rfsech(k, m, beta, dt=0.0):
    return _fir_design_fnyquist("fsech", True, k, m, beta)


def fir_design_farcsech(k, m, beta, dt=0.0):
    return _fir_design_fnyquist("farcsech", False, k, m, beta)


def fir_design_rfarcsech(k, m, beta, dt=0.0):
    return _fir_design_fnyquist("farcsech", True, k, m, beta)


# GMSK (design/gmsk.rs)
def fir_design_gmsktx(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """GMSK transmit (Gaussian) filter (design/gmsk.rs:20)."""
    _validate_km_beta(k, m, beta)
    h_len = 2 * k * m + 1
    c0 = 1.0 / np.sqrt(np.log(2.0))
    i = np.arange(h_len, dtype=np.float64)
    t = i / k - m + dt
    h = np.array(
        [
            qf(2.0 * np.pi * beta * (ti - 0.5) * c0)
            - qf(2.0 * np.pi * beta * (ti + 0.5) * c0)
            for ti in t
        ]
    )
    e = np.sum(h)
    return h * (np.pi / (2.0 * e) * k)


def fir_design_gmskrx(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """GMSK receive filter via spectral division (design/gmsk.rs:66)."""
    _validate_km_beta(k, m, beta)
    bt = beta
    delta = 1e-3
    h_len = 2 * k * m + 1

    ht = fir_design_gmsktx(k, m, bt, 0.0)
    h_primef = fir_design_prototype(FirFilterShape.KAISER, k, m, bt, 0.0)
    fc = (0.7 + 0.1 * bt) / k
    g_primef = fir_design_kaiser(h_len, fc, 60.0, 0.0)

    shift = lambda v: np.roll(v, -(k * m))  # noqa: E731  (center at index 0)
    H_tx = np.fft.fft(shift(ht))
    H_prime = np.fft.fft(shift(h_primef))
    G_prime = np.fft.fft(shift(g_primef))

    h_tx_min = H_tx.real.min()
    h_prime_min = H_prime.real.min()
    g_prime_min = G_prime.real.min()

    H_hat = (H_prime.real - h_prime_min + delta) / (H_tx.real - h_tx_min + delta)
    H_hat = H_hat * (G_prime.real - g_prime_min) / G_prime.real[0]

    # unnormalized inverse fft then liquid's shift/scale (gmsk.rs:152-160)
    h_hat = np.fft.ifft(H_hat.astype(np.complex128)) * h_len
    idx = (np.arange(h_len) + k * m + 1) % h_len
    hr = h_hat[idx].real / (k * h_len)
    return hr * (k * k)


# rkaiser family (design/rkaiser.rs)
def _rkaiser_approximate_rho(m: int, beta: float) -> float:
    """Polynomial fit of optimum rho (rkaiser.rs:104)."""
    if m < 1:
        raise ConfigError("m must be greater than 0")
    if beta < 0.0 or beta > 1.0:
        raise ConfigError("beta must be in [0,1]")
    table = {
        1: (0.75749731, 0.06134303, -0.08729663),
        2: (0.81151861, 0.07437658, -0.01427088),
        3: (0.84249538, 0.07684185, -0.00536879),
        4: (0.86140782, 0.07144126, -0.00558652),
        5: (0.87457740, 0.06578694, -0.00650447),
        6: (0.88438797, 0.06074265, -0.00736405),
        7: (0.89216620, 0.05669236, -0.00791222),
        8: (0.89874983, 0.05361696, -0.00815301),
        9: (0.90460032, 0.05167952, -0.00807893),
        10: (0.91034430, 0.05130753, -0.00746192),
        11: (0.91587675, 0.05180436, -0.00670711),
        12: (0.92121875, 0.05273801, -0.00588351),
        13: (0.92638195, 0.05400764, -0.00508452),
        14: (0.93123555, 0.05516163, -0.00437306),
        15: (0.93564993, 0.05596561, -0.00388152),
        16: (0.93976742, 0.05662274, -0.00348280),
        17: (0.94351703, 0.05694120, -0.00318821),
        18: (0.94557273, 0.05227591, -0.00400676),
        19: (0.95001614, 0.05681641, -0.00300628),
        20: (0.95281708, 0.05637607, -0.00304790),
        21: (0.95536256, 0.05575880, -0.00312988),
        22: (0.95754206, 0.05426060, -0.00385945),
    }
    c0, c1, c2 = table.get(
        m, (0.056873 * np.log(m + 1e-3) + 0.781388, 0.05426, -0.00386)
    )
    b = np.log(beta)
    return float(np.clip(c0 + c1 * b + c2 * b * b, 0.0, 1.0))


def _rkaiser_validate(k, m, beta, dt):
    if k < 2:
        raise ConfigError("k must be at least 2")
    if m < 1:
        raise ConfigError("m must be at least 1")
    if beta <= 0.0 or beta >= 1.0:
        raise ConfigError("beta must be in (0,1)")
    if dt < -1.0 or dt > 1.0:
        raise ConfigError("dt must be in [-1,1]")


def _rkaiser_internal(k, m, beta, dt, rho):
    """Design for a given rho; return (h, isi_rms) (rkaiser.rs:260)."""
    if rho < 0.0 or rho > 1.0:
        raise ConfigError(f"rho must be in [0,1], got {rho}")
    n = 2 * k * m + 1
    delta = beta * rho / k
    as_ = estimate_req_filter_stopband_attenuation(delta, n)
    fc = 0.5 * (1.0 + beta * (1.0 - rho)) / k
    h = fir_design_kaiser(n, fc, as_, dt)
    isi_rms, _ = filter_isi(h, k, m)
    return h, isi_rms


def fir_design_arkaiser(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Approximate root-Nyquist Kaiser (rkaiser.rs:49)."""
    _rkaiser_validate(k, m, beta, dt)
    c0 = 0.762886 + 0.067663 * np.log(m)
    c1 = 0.065515
    c2 = np.log(1.0 - 0.088 * m ** (-1.6))
    lb = np.log(beta)
    rho_hat = c0 + c1 * lb + c2 * lb * lb
    if rho_hat <= 0.0 or rho_hat >= 1.0:
        rho_hat = _rkaiser_approximate_rho(m, beta)
    n = 2 * k * m + 1
    delta = beta * rho_hat / k
    as_ = estimate_req_filter_stopband_attenuation(delta, n)
    fc = 0.5 * (1.0 + beta * (1.0 - rho_hat)) / k
    h = fir_design_kaiser(n, fc, as_, dt)
    return h * np.sqrt(k / np.sum(h * h))


def fir_design_rkaiser(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """True-optimum root-Nyquist Kaiser via parabolic ISI search (rkaiser.rs:16,160)."""
    _rkaiser_validate(k, m, beta, dt)
    rho_hat = _rkaiser_approximate_rho(m, beta)
    x1 = rho_hat
    rho_opt, y_opt = rho_hat, 0.0
    dx, tol = 0.2, 1e-6
    for p in range(14):
        x0 = max(x1 - dx, 0.01)
        x2 = min(x1 + dx, 0.99)
        _, y0 = _rkaiser_internal(k, m, beta, dt, x0)
        _, y1 = _rkaiser_internal(k, m, beta, dt, x1)
        _, y2 = _rkaiser_internal(k, m, beta, dt, x2)
        if p == 0 or y1 < y_opt:
            rho_opt, y_opt = x1, y1
        ta = y0 * (x1**2 - x2**2) + y1 * (x2**2 - x0**2) + y2 * (x0**2 - x1**2)
        tb = y0 * (x1 - x2) + y1 * (x2 - x0) + y2 * (x0 - x1)
        if tb == 0.0:
            break
        x_hat = 0.5 * ta / tb
        if x_hat < x0 or x_hat > x2:
            break
        if p > 3 and abs(x_hat - x1) < tol:
            break
        x1 = x_hat
        dx *= 0.5
    h, _ = _rkaiser_internal(k, m, beta, dt, rho_opt)
    return h * np.sqrt(k / np.sum(h * h))


def fir_design_hm3(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Harris-Moerder-3 root-Nyquist via iterated PM (design/hm3.rs:21)."""
    if k < 2:
        raise ConfigError("k must be greater than 1")
    if m < 1:
        raise ConfigError("m must be greater than 0")
    if beta < 0.0 or beta > 1.0:
        raise ConfigError("beta must be in [0,1]")
    n = 2 * k * m + 1
    fc = 1.0 / (2.0 * k)
    fs = fc * (1.0 + beta)
    des = [1.0, 1.0 / np.sqrt(2.0), 0.0]
    weights = [1.0, 1.0, 1.0]
    wtype = [FirPmWeightType.FLAT, FirPmWeightType.FLAT, FirPmWeightType.EXP]

    def design(fp):
        return fir_design_pm(
            n, [0.0, fp, fc, fc, fs, 0.5], des, weights, wtype, FirPmBandType.BANDPASS
        )

    h = design(fc * (1.0 - beta))
    isi_rms_min, _ = filter_isi(h, k, m)
    pmax = 100
    for p in range(pmax):
        fp = fc * (1.0 - beta * p / pmax)
        h_pm = design(fp)
        isi_rms, _ = filter_isi(h_pm, k, m)
        if isi_rms > isi_rms_min:
            break
        isi_rms_min = isi_rms
        h = h_pm
    return h * np.sqrt(k / np.sum(h * h))


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
            FirPmBandType.BANDPASS,
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
    """(root-)Nyquist prototype dispatch (design/mod.rs:392)."""
    h_len = 2 * k * m + 1
    fc = 0.5 / k
    df = beta / k
    if ftype == FirFilterShape.KAISER:
        as_ = estimate_req_filter_stopband_attenuation(df, h_len)
        return fir_design_kaiser(h_len, fc, as_, dt)
    if ftype == FirFilterShape.PM:
        bands = [0.0, fc - 0.5 * df, fc, fc, fc + 0.5 * df, 0.5]
        des = [float(k), 0.5 * k, 0.0]
        weights = [1.0, 1.0, 1.0]
        wtype = [FirPmWeightType.FLAT] * 3
        return fir_design_pm(h_len, bands, des, weights, wtype, FirPmBandType.BANDPASS)
    dispatch = {
        FirFilterShape.RCOS: fir_design_rcos,
        FirFilterShape.FEXP: fir_design_fexp,
        FirFilterShape.FSECH: fir_design_fsech,
        FirFilterShape.FARCSECH: fir_design_farcsech,
        FirFilterShape.ARKAISER: fir_design_arkaiser,
        FirFilterShape.RKAISER: fir_design_rkaiser,
        FirFilterShape.RRCOS: fir_design_rrcos,
        FirFilterShape.HM3: fir_design_hm3,
        FirFilterShape.GMSKTX: fir_design_gmsktx,
        FirFilterShape.GMSKRX: fir_design_gmskrx,
        FirFilterShape.RFEXP: fir_design_rfexp,
        FirFilterShape.RFSECH: fir_design_rfsech,
        FirFilterShape.RFARCSECH: fir_design_rfarcsech,
    }
    return dispatch[ftype](k, m, beta, dt)


# ------------------------------------------------------------- filter stats
def filter_autocorr(h, lag: int) -> float:
    """Autocorrelation at lag (design/mod.rs:495)."""
    h = np.asarray(h, dtype=np.float64)
    lag = abs(int(lag))
    if lag >= len(h):
        return 0.0
    return float(np.sum(h[lag:] * h[: len(h) - lag]))


def filter_crosscorr(h, g, lag: int) -> float:
    """Cross-correlation at lag (design/mod.rs:522)."""
    h = np.asarray(h, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    if len(h) < len(g):
        return filter_crosscorr(g, h, -lag)
    if lag <= -len(g) or lag >= len(h):
        return 0.0
    ig = -lag if lag < 0 else 0
    ih = lag if lag > 0 else 0
    if lag < 0:
        n = len(g) + lag
    elif lag < len(h) - len(g):
        n = len(g)
    else:
        n = len(h) - lag
    return float(np.sum(h[ih : ih + n] * g[ig : ig + n]))


def filter_isi(h, k: int, m: int) -> tuple[float, float]:
    """Inter-symbol interference, RMS and max (design/mod.rs:571)."""
    rxx0 = filter_autocorr(h, 0)
    isi_rms = 0.0
    isi_max = 0.0
    for i in range(1, 2 * m):
        e = abs(filter_autocorr(h, i * k) / rxx0)
        isi_rms += e * e
        if i == 1 or e > isi_max:
            isi_max = e
    return float(np.sqrt(isi_rms / (2 * m))), isi_max


def filter_energy(h, fc: float, nfft: int) -> float:
    """Relative out-of-band energy (design/mod.rs:596)."""
    h = np.asarray(h, dtype=np.float64)
    if fc < 0.0 or fc > 0.5:
        raise ConfigError(f"cutoff frequency ({fc}) out of range [0, 0.5]")
    if len(h) == 0:
        raise ConfigError("filter coefficients must be non-empty")
    if nfft == 0:
        raise ConfigError("fft size must be greater than zero")
    i = np.arange(nfft)
    f = 0.5 * i / nfft
    k = np.arange(len(h))
    ejwt = np.exp(2j * np.pi * f[:, None] * k[None, :])
    v = ejwt @ h
    e2 = np.abs(v) ** 2
    return float(np.sum(e2[f >= fc]) / np.sum(e2))


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
