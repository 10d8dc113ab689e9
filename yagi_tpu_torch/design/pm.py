"""Parks-McClellan (Remez exchange) FIR design.

Copied from :mod:`yagi_tpu.design.pm` (pm.rs; [McClellan:1973],
[Janovetz:1998]): float64 throughout, the reference's grid construction,
barycentric Lagrange interpolation, extremal search with alternation
enforcement and stopping criteria, the bandpass, differentiator and Hilbert
band types and the PM lowpass, so the taps equal yagi_tpu's bit for bit.
"""

from __future__ import annotations

import enum
from typing import Callable, Sequence

import numpy as np

from ..errors import ConfigError

__all__ = [
    "FirPmBandType",
    "FirPmWeightType",
    "FirDesignPm",
    "fir_design_pm",
    "fir_design_pm_lowpass",
]

_IEXT_SEARCH_TOL = 1e-15  # pm.rs:33


class FirPmBandType(enum.Enum):
    BANDPASS = "bandpass"
    DIFFERENTIATOR = "differentiator"
    HILBERT = "hilbert"


class FirPmWeightType(enum.Enum):
    FLAT = "flat"
    EXP = "exp"
    LIN = "lin"


def _barycentric_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric weights, normalized by w[0] (math/poly.rs:347)."""
    n = len(x)
    w = np.ones(n, dtype=np.float64)
    for i in range(n):
        w[i] = 1.0 / np.prod(x[i] - np.delete(x, i))
    return w / w[0]


def _barycentric_eval(x: np.ndarray, y: np.ndarray, w: np.ndarray, x0: np.ndarray) -> np.ndarray:
    """Vectorized barycentric Lagrange evaluation at many points x0."""
    x0 = np.atleast_1d(np.asarray(x0, dtype=np.float64))
    diff = x0[:, None] - x[None, :]  # [n0, n]
    hit = np.isclose(diff, 0.0, atol=0.0)
    safe = np.where(hit, 1.0, diff)
    t = w[None, :] / safe
    num = np.sum(t * y[None, :], axis=1)
    den = np.sum(t, axis=1)
    out = num / den
    # exact node hits
    any_hit = hit.any(axis=1)
    if np.any(any_hit):
        idx = hit.argmax(axis=1)
        out = np.where(any_hit, y[idx], out)
    return out


class FirDesignPm:
    """Remez exchange state (pm.rs:64-87)."""

    def __init__(
        self,
        h_len: int,
        bands: Sequence[float],
        des: Sequence[float] | None,
        weights: Sequence[float] | None = None,
        wtype: Sequence[FirPmWeightType] | None = None,
        btype: FirPmBandType = FirPmBandType.BANDPASS,
        callback: Callable[[float], tuple[float, float]] | None = None,
        grid_density: int = 20,
    ):
        bands = np.asarray(bands, dtype=np.float64).ravel()
        if h_len == 0:
            raise ConfigError("invalid filter length")
        if len(bands) == 0 or len(bands) % 2 != 0:
            raise ConfigError("invalid number of bands")
        num_bands = len(bands) // 2
        if np.any(bands < 0.0) or np.any(bands > 0.5) or np.any(np.diff(bands) < 0):
            raise ConfigError("invalid bands")
        if weights is not None and np.any(np.asarray(weights) <= 0.0):
            raise ConfigError("invalid weights")

        self.h_len = h_len
        self.s = h_len % 2
        n = (h_len - self.s) // 2
        self.r = n + self.s  # number of approximating functions
        self.num_bands = num_bands
        self.btype = btype
        self.grid_density = grid_density
        self.bands = bands
        self.des = None if des is None else np.asarray(des, dtype=np.float64)
        self.weights = (
            np.ones(num_bands) if weights is None else np.asarray(weights, dtype=np.float64)
        )
        self.wtype = (
            [FirPmWeightType.FLAT] * num_bands if wtype is None else list(wtype)
        )
        self._create_grid(callback)

    # ------------------------------------------------------------------ grid
    def _create_grid(self, callback) -> None:
        """Dense frequency grid with desired response / weights (pm.rs:283)."""
        df = 0.5 / (self.grid_density * self.r)
        fs, ds, ws = [], [], []
        for i in range(self.num_bands):
            f0 = self.bands[2 * i]
            if i == 0 and self.btype != FirPmBandType.BANDPASS:
                f0 = max(f0, df)  # avoid f=0 for differentiator/Hilbert
            f1 = self.bands[2 * i + 1]
            num_points = max(1, int(np.floor((f1 - f0) / df + 0.5)))
            j = np.arange(num_points)
            f = f0 + j * df
            f[-1] = f1  # force endpoint to band edge
            if callback is not None:
                d = np.empty(num_points)
                w = np.empty(num_points)
                for idx, fi in enumerate(f):
                    d[idx], w[idx] = callback(fi)
            else:
                d = np.full(num_points, self.des[i])
                if self.wtype[i] == FirPmWeightType.FLAT:
                    fw = np.ones(num_points)
                elif self.wtype[i] == FirPmWeightType.EXP:
                    fw = np.exp(2.0 * j * df)
                else:  # LIN
                    fw = 1.0 + 2.7 * j * df
                w = self.weights[i] * fw
            fs.append(f)
            ds.append(d)
            ws.append(w)

        self.f = np.concatenate(fs)
        self.d = np.concatenate(ds)
        self.w = np.concatenate(ws)
        self.grid_size = len(self.f)

        # symmetry transforms (pm.rs:333-357)
        if self.btype == FirPmBandType.BANDPASS:
            if self.s == 0:
                c = np.cos(np.pi * self.f)
                self.d = self.d / c
                self.w = self.w * c
        else:
            if self.s == 0:
                c = np.sin(np.pi * self.f)
            else:
                c = np.sin(2.0 * np.pi * self.f)
            self.d = self.d / c
            self.w = self.w * c

    # ------------------------------------------------------------- remez core
    def _compute_interp(self) -> None:
        """Interpolating polynomial + extremal error rho (pm.rs:362)."""
        self.x = np.cos(2.0 * np.pi * self.f[self.iext])
        self.alpha = _barycentric_weights(self.x)
        sgn = np.where(np.arange(self.r + 1) % 2 == 1, -1.0, 1.0)
        t0 = np.sum(self.alpha * self.d[self.iext])
        t1 = np.sum(self.alpha / self.w[self.iext] * sgn)
        self.rho = t0 / t1
        self.c = self.d[self.iext] - sgn * self.rho / self.w[self.iext]

    def _compute_error(self) -> None:
        """Weighted error over the whole grid (pm.rs:389)."""
        xf = np.cos(2.0 * np.pi * self.f)
        h = _barycentric_eval(self.x, self.c, self.alpha, xf)
        self.e = self.w * (self.d - h)

    def _iext_search(self) -> None:
        """Find new extremal indices, enforcing alternation (pm.rs:400)."""
        e = self.e
        nmax = 2 * self.r + 2 * self.num_bands
        found = [0]  # force f=0
        interior = np.arange(1, self.grid_size - 1)
        pos_peak = (e[interior] >= 0) & (e[interior - 1] <= e[interior]) & (
            e[interior + 1] <= e[interior]
        )
        neg_peak = (e[interior] < 0) & (e[interior - 1] >= e[interior]) & (
            e[interior + 1] >= e[interior]
        )
        for i in interior[pos_peak | neg_peak]:
            # skip duplicate frequencies (coincident band edges appear twice
            # on the grid; two equal Chebyshev nodes would break the
            # barycentric interpolation with a 0-distance division)
            if len(found) < nmax and self.f[i] != self.f[found[-1]]:
                found.append(int(i))
        if len(found) < nmax and self.f[self.grid_size - 1] != self.f[found[-1]]:
            found.append(self.grid_size - 1)  # force f=0.5

        if len(found) < self.r + 1:
            self.num_exchanges = 0
            return

        num_extra = len(found) - (self.r + 1)
        while num_extra > 0:
            last_positive = e[found[0]] > 0.0
            imin = 0
            alternating = True
            for i in range(1, len(found)):
                if abs(e[found[i]]) < abs(e[found[imin]]) - _IEXT_SEARCH_TOL:
                    imin = i
                if last_positive and e[found[i]] < 0.0:
                    last_positive = False
                elif not last_positive and e[found[i]] >= 0.0:
                    last_positive = True
                else:
                    # two extrema with non-alternating sign: drop the smaller
                    if abs(e[found[i]]) < abs(e[found[i - 1]]):
                        imin = i
                    else:
                        imin = i - 1
                    alternating = False
                    break
            if alternating and num_extra == 1:
                imin = 0 if abs(e[found[0]]) < abs(e[found[-1]]) else len(found) - 1
            del found[imin]
            num_extra -= 1

        new_iext = np.asarray(found[: self.r + 1], dtype=np.int64)
        self.num_exchanges = int(np.sum(new_iext != self.iext))
        self.iext = new_iext

    def _is_search_complete(self) -> bool:
        """Convergence check (pm.rs:509)."""
        if self.num_exchanges == 0:
            return True
        e = np.abs(self.e[self.iext])
        emin, emax = e.min(), e.max()
        return (emax - emin) / emax < 1e-3

    def _compute_taps(self) -> np.ndarray:
        """Inverse-transform the best cosine approximation (pm.rs:532)."""
        self._compute_interp()
        p = self.r - self.s + 1
        i = np.arange(p)
        f = i / self.h_len
        xf = np.cos(2.0 * np.pi * f)
        cf = _barycentric_eval(self.x, self.c, self.alpha, xf)
        if self.btype == FirPmBandType.BANDPASS and self.s == 0:
            g = cf * np.cos(np.pi * i / self.h_len)
        elif self.btype != FirPmBandType.BANDPASS:
            # re-apply the antisymmetric amplitude factor divided out of the
            # grid (type IV: sin(pi f); type III: sin(2 pi f))
            g = cf * (np.sin(np.pi * f) if self.s == 0 else np.sin(2.0 * np.pi * f))
        else:
            g = cf

        n = np.arange(self.h_len)
        fr = (n - (p - 1) + 0.5 * (1.0 - self.s)) / self.h_len
        j = np.arange(1, self.r)
        if self.btype == FirPmBandType.BANDPASS:
            v = g[0] + 2.0 * np.sum(
                g[None, 1 : self.r] * np.cos(2.0 * np.pi * fr[:, None] * j[None, :]),
                axis=1,
            )
            return (v / self.h_len).astype(np.float32)

        # antisymmetric (differentiator / Hilbert) inverse transform: with
        # H(f) = j G(f) e^{-j2pi f alpha}, alpha=(N-1)/2, pairing k and N-k
        # DFT bins gives h[n] = -(2/N) sum_k G_k sin(2pi k (n-alpha)/N)
        # (type III, N odd) plus the k=N/2 boundary term
        # -(1/N) G_{N/2} (-1)^{n+N/2} (type IV, N even); G_0 = 0 in both.
        v = -2.0 * np.sum(
            g[None, 1 : self.r] * np.sin(2.0 * np.pi * fr[:, None] * j[None, :]),
            axis=1,
        )
        if self.s == 0:
            v = v - g[self.r] * ((-1.0) ** (n + self.h_len // 2))
        return (v / self.h_len).astype(np.float32)

    def execute(self) -> np.ndarray:
        """Run the Remez exchange (pm.rs:155-181)."""
        self.iext = (np.arange(self.r + 1) * (self.grid_size - 1)) // self.r
        self.num_exchanges = 0
        for _ in range(40):
            self._compute_interp()
            self._compute_error()
            self._iext_search()
            if self._is_search_complete():
                break
        return self._compute_taps()


def fir_design_pm(
    h_len: int,
    bands,
    des,
    weights=None,
    wtype=None,
    btype: FirPmBandType = FirPmBandType.BANDPASS,
) -> np.ndarray:
    """One-shot Parks-McClellan design (pm.rs:607)."""
    return FirDesignPm(h_len, bands, des, weights, wtype, btype).execute()


def fir_design_pm_lowpass(n: int, fc: float, as_: float, mu: float = 0.0) -> np.ndarray:
    """PM lowpass given cutoff + attenuation (pm.rs:632)."""
    from .fir import estimate_req_filter_transition_bandwidth

    if mu < -0.5 or mu > 0.5:
        raise ConfigError(f"mu ({mu}) out of range [-0.5,0.5]")
    if fc < 0.0 or fc > 0.5:
        raise ConfigError(f"cutoff frequency ({fc}) out of range (0, 0.5)")
    if n == 0:
        raise ConfigError("filter length must be greater than zero")

    ft = estimate_req_filter_transition_bandwidth(as_, n)
    fp = fc - 0.5 * ft
    fs = fc + 0.5 * ft
    return fir_design_pm(
        n,
        [0.0, fp, fs, 0.5],
        [1.0, 0.0],
        weights=[1.0, 1.0],
        wtype=[FirPmWeightType.FLAT, FirPmWeightType.EXP],
        btype=FirPmBandType.BANDPASS,
    )
