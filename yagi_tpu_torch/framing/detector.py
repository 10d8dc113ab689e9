"""Detector: streaming preamble detector (liquid ``detector_cccf``).

Port of :mod:`yagi_tpu.framing.detector` (behavioral spec: liquid-dsp's
``detector_cccf``): feed samples continuously; where the normalized
cross-correlation against a known complex template crosses the threshold,
report a detection with timing offset ``tau`` (sub-sample, absolute in the
stream), carrier frequency offset ``dphi``, phase and channel gain
``gamma``.

It runs :class:`~.qdetector.QDetector`'s correlation surface
(:func:`~.qdetector._xcorr_surface`, one [n_dphi, nfft] product a block) on
the object's device; the only sequential state is the (L−1)-sample tail
carried between blocks, so a template straddling a block boundary is
still found. Detections are taken greedily from the surface normalized by
the local received energy (a float64 window sum, as yagi_tpu's
``np.convolve`` with float64 ones), the first maximum in (hypothesis, lag)
order each time, with a ±L/2 debounce; each one comes to the host in one
read and is interpolated as QDetector's (``_peak_values``, ``_estimates``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ConfigError
from ._sync import as_samples
from .qdetector import QDetector, _xcorr_surface

__all__ = ["Detector"]


class Detector:
    """Streaming known-template detector with tau/dphi/gamma estimates, on
    ``device`` (the current CUDA device by default)."""

    def __init__(self, sequence, threshold: float = 0.5, dphi_max: float = 0.02,
                 n_dphi: int = 9, max_detections_per_block: int = 4, device=None):
        # reuse QDetector's validated hypothesis bank
        self._q = QDetector(sequence, threshold=threshold, dphi_max=dphi_max, n_dphi=n_dphi,
                            device=device)
        self.device = self._q.device
        self.L = self._q.L
        self.threshold = float(threshold)
        self.max_det = int(max_detections_per_block)
        if self.max_det < 1:
            raise ConfigError("max_detections_per_block must be >= 1")
        self.reset()

    def reset(self) -> None:
        self._tail = torch.zeros(0, dtype=torch.complex64, device=self.device)
        self._offset = 0  # absolute sample index of _tail[0]

    def execute(self, block):
        """Process the next block (a tensor or a numpy array); returns a list
        of detection dicts, each with keys ``tau`` (absolute sample offset
        of the template's start, sub-sample), ``dphi``, ``phi``, ``gamma``,
        ``rxy``, in order of tau."""
        x = torch.cat([self._tail, as_samples(block, self.device)])
        N, q = x.shape[0], self._q
        out = []
        if N >= self.L:
            nfft = 1 << int(np.ceil(np.log2(N + q.L)))
            R = _xcorr_surface(x, q._bank, nfft)
            mag = R.abs()
            n_lags = N - q.L + 1
            # normalized correlation per lag against the local received
            # energy: window sums of the float32 |x|² in float64 (exact in
            # any order for these magnitudes, like numpy's convolution)
            e_loc = x.abs().square().to(torch.float64).unfold(0, q.L, 1).sum(-1)
            norm = torch.sqrt(q._e_s * torch.clamp(e_loc, min=1e-20))
            # detect on the normalized surface, the quantity the threshold
            # tests, so a weak burst in a low-energy region is not shadowed
            # by a strong sub-threshold interferer
            surf = mag[:, :n_lags].to(torch.float64) / norm[None, :]
            for _ in range(self.max_det):
                flat = torch.argmax(surf.reshape(-1))
                h, lag, rxy, peak, *near = q._peak_values(R, mag, flat, n_lags,
                                                         surf.reshape(-1)[flat])
                if rxy < self.threshold:
                    break
                est = q._estimates(h, lag, peak, *near)
                out.append({**est, "tau": self._offset + est["tau"], "rxy": float(rxy)})
                # debounce: suppress the neighbourhood of this peak
                lo = max(0, lag - q.L // 2)
                hi = min(n_lags, lag + q.L // 2 + 1)
                surf[:, lo:hi] = 0.0
        # carry the last L−1 samples so a straddling template is found
        keep = min(self.L - 1, N)
        self._offset += N - keep
        self._tail = x[N - keep:]
        out.sort(key=lambda d: d["tau"])
        return out
