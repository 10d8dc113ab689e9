"""qdetector: known-sequence burst detector / synchronizer front-end.

Port of :mod:`yagi_tpu.framing.qdetector` (behavioral spec: liquid-dsp's
qdetector_cccf): given a known template sequence, find it in a received
buffer and estimate timing offset (to sub-sample resolution), carrier
frequency offset, carrier phase, and channel gain.

Detection is FFT cross-correlation of the buffer against a bank of
carrier-offset hypotheses (the template pre-rotated by each trial dphi),
one ``[n_dphi, nfft]`` frequency-domain product and inverse FFT, nfft the
next power of two of N + L. The peak is the first maximum of the
flattened ``[n_dphi, n_lags]`` magnitude (numpy's ``argmax`` rule, which
``torch.argmax`` keeps); sub-sample timing and sub-bin frequency come from
quadratic interpolation around the peak in each axis.

Where it runs: yagi_tpu's jitted FFT surface runs in torch (complex64) on
the object's device, and so do the peak search, its neighbours and the
buffer's energy under the template; one host read a detection brings back
the peak, its four neighbours, the correlation there and that energy. The
threshold test and the interpolation run on the host in numpy float32, as
in yagi_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ._sync import as_samples

__all__ = ["QDetector"]


def _xcorr_surface(x: torch.Tensor, bank: torch.Tensor, nfft: int) -> torch.Tensor:
    """Cross-correlation R [H, nfft] (complex64) of the buffer x [N] with
    each row of the hypothesis bank [H, L]: one frequency-domain product
    and inverse FFT (yagi_tpu's ``qdetector.py:33``)."""
    X = torch.fft.fft(x, nfft)
    return torch.fft.ifft(X[None, :] * torch.fft.fft(bank, nfft, dim=-1).conj(), dim=-1)


def _quad_peak(ym1, y0, yp1):
    """Offset in [-0.5, 0.5] of the vertex of the parabola through 3 pts
    (float32 operands)."""
    denom = ym1 - np.float32(2.0) * y0 + yp1
    off = np.float32(0.5) * (ym1 - yp1) / denom if np.abs(denom) > 1e-12 else np.float32(0.0)
    return np.clip(off, -0.5, 0.5)


class QDetector:
    """Burst detector for a known complex template, on ``device`` (the
    current CUDA device by default)."""

    def __init__(self, sequence, threshold: float = 0.5,
                 dphi_max: float = 0.02, n_dphi: int = 9, device=None):
        if isinstance(sequence, torch.Tensor):
            sequence = sequence.cpu().numpy()
        sequence = np.asarray(sequence, dtype=np.complex64).ravel()
        if sequence.size < 8:
            raise ConfigError(
                f"sequence length ({sequence.size}) must be >= 8")
        if not 0.0 < threshold < 2.0:
            raise ConfigError(f"threshold ({threshold}) must be in (0,2)")
        if n_dphi < 1 or n_dphi % 2 == 0:
            raise ConfigError(f"n_dphi ({n_dphi}) must be odd and >= 1")
        self.device = resolve_device(device)
        self.s = sequence
        self.L = sequence.size
        self.threshold = float(threshold)
        self.dphis = np.linspace(-dphi_max, dphi_max, n_dphi) \
            if n_dphi > 1 else np.zeros(1)
        n = np.arange(self.L)
        # hypothesis h matches a received offset of +dphis[h]: the conjugate
        # in the correlation cancels exp(+j*dphi*n) exactly at the true CFO
        rot = np.exp(1j * self.dphis[:, None] * n[None, :])
        self._bank = torch.from_numpy(
            (sequence[None, :] * rot).astype(np.complex64)).to(self.device)  # [H, L]
        self._e_s = float(np.sum(np.abs(sequence) ** 2))

    def detect(self, x):
        """Search buffer ``x`` (a tensor or a numpy array) for the template.

        Returns None below threshold, else a dict with:
        ``tau`` (start offset in samples, sub-sample resolution),
        ``dphi`` (carrier offset rad/sample), ``phi`` (carrier phase at
        tau), ``gamma`` (linear channel gain), ``rxy`` (normalized
        correlation peak in [0,1])."""
        x = as_samples(x, self.device)
        N = x.shape[0]
        if N < self.L:
            raise ConfigError(f"buffer ({N}) shorter than sequence ({self.L})")
        nfft = 1 << int(np.ceil(np.log2(N + self.L)))
        R = _xcorr_surface(x, self._bank, nfft)
        mag = R.abs()
        n_lags = N - self.L + 1
        # the first maximum over (hypothesis, lag), on the device
        flat = torch.argmax(mag[:, :n_lags].reshape(-1))
        lag = flat % n_lags
        e_x = x[lag + torch.arange(self.L, device=self.device)].abs().square().sum()
        h, lag, e_x, peak, *near = self._peak_values(R, mag, flat, n_lags, e_x)
        # normalized correlation vs local energy
        rxy = peak / np.sqrt(self._e_s * (float(np.float32(e_x)) + 1e-20))
        if rxy < self.threshold:
            return None
        return {**self._estimates(h, lag, peak, *near), "rxy": float(rxy)}

    def _peak_values(self, R: torch.Tensor, mag: torch.Tensor, flat: torch.Tensor, n_lags: int,
                     *extra: torch.Tensor) -> list:
        """One host read at the surface point ``flat`` = h·n_lags + lag: h and
        lag (ints), the 0-dim ``extra`` values, the magnitude there (float32)
        and at lag − 1, lag + 1, h − 1, h + 1 (a clamped index: an edge takes
        the peak itself in :meth:`_estimates`), and R there (re, im)."""
        H, nfft = mag.shape
        h, lag = flat // n_lags, flat % n_lags
        at = h * nfft + lag
        near = torch.stack([at, at - 1, at + 1, at - nfft, at + nfft]).clamp(0, H * nfft - 1)
        r = R.reshape(-1)[at.reshape(1)]
        vals = torch.cat([torch.stack([h, lag]).to(torch.float64),
                          *(e.reshape(1).to(torch.float64) for e in extra),
                          mag.reshape(-1)[near].to(torch.float64),
                          torch.cat([r.real, r.imag]).to(torch.float64)]).tolist()
        n = 2 + len(extra)
        return ([int(vals[0]), int(vals[1])] + vals[2:n]
                + [np.float32(v) for v in vals[n: n + 5]] + vals[n + 5:])

    def _estimates(self, h: int, lag: int, peak, ym1, yp1, hm1, hp1, r_re: float,
                   r_im: float) -> dict:
        """tau (from the lag, sub-sample), dphi (from the hypothesis, sub-bin),
        phi and gamma of a peak: quadratic interpolation in float32 around
        it, as yagi_tpu."""
        H = len(self.dphis)
        ym1 = ym1 if lag > 0 else peak
        dtau = float(_quad_peak(ym1, peak, yp1))
        if H > 1:
            hm1 = hm1 if h > 0 else peak
            hp1 = hp1 if h + 1 < H else peak
            dh = float(_quad_peak(hm1, peak, hp1))
            dphi = float(self.dphis[h] + dh * (self.dphis[1] - self.dphis[0]))
        else:
            dphi = 0.0
        return {
            "tau": float(lag) + dtau,
            "dphi": dphi,
            "phi": float(np.angle(np.complex64(complex(r_re, r_im)))),
            "gamma": float(peak / self._e_s),
        }
