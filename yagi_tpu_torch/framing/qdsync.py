"""qdsync: detector + symbol synchronizer for burst streams.

Port of :mod:`yagi_tpu.framing.qdsync` (behavioral spec: liquid-dsp's
qdsync_cccf, LIQUID_COMPAT.md:1154-1162): given a known preamble symbol
sequence and a root-Nyquist pulse (k samples/symbol, delay m, excess
bandwidth beta), detect the preamble in a raw sample stream, recover timing
(sub-sample), carrier frequency/phase and gain, and emit synchronized
symbols at 1 sample/symbol from the preamble start onward.

Detection is the :class:`QDetector` FFT correlation bank; the corrections
are closed-form whole-buffer vector ops (rotate, FFT fractional shift, one
matched-filter convolution, strided gather): burst = block.

Where it runs: the pulse and the detection template are designed on the
host once (numpy, as yagi_tpu). ``execute`` runs on the object's device:
the detection (one host read), then the derotation, fractional advance,
matched filter and weighted phase fit in complex128 (:mod:`._sync`), where
yagi_tpu computes them in numpy; the symbols come back as complex64 on the
device and the stats in one more host read.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..design import fir as fir_design
from ..errors import ConfigError
from . import _sync
from .qdetector import QDetector

__all__ = ["QDSync"]


class QDSync:
    """Burst symbol synchronizer keyed on a known preamble.

    Parameters mirror ``qdsync_cccf_create(seq, k, m, beta)``:
    ``preamble`` — known symbols; ``k`` — samples/symbol; ``m`` — filter
    semi-length in symbols; ``beta`` — excess bandwidth. It runs on
    ``device`` (the current CUDA device by default).
    """

    def __init__(self, preamble, k: int = 2, m: int = 7, beta: float = 0.3,
                 threshold: float = 0.5, dphi_max: float = 0.02,
                 n_dphi: int = 13, device=None):
        if isinstance(preamble, torch.Tensor):
            preamble = preamble.cpu().numpy()
        preamble = np.asarray(preamble, dtype=np.complex64).ravel()
        if preamble.size < 8:
            raise ConfigError(
                f"preamble length ({preamble.size}) must be >= 8")
        if k < 2:
            raise ConfigError(f"samples/symbol ({k}) must be >= 2")
        if m < 1:
            raise ConfigError(f"filter delay ({m}) must be >= 1")
        if not 0.0 < beta <= 1.0:
            raise ConfigError(f"excess bandwidth ({beta}) must be in (0,1]")
        self.device = resolve_device(device)
        self.preamble = torch.from_numpy(preamble).to(self.device)
        self.k = k
        self.m = m
        self.beta = float(beta)
        h = fir_design.fir_design_arkaiser(k, m, beta, 0.0)
        self._h = (h / np.sqrt(np.sum(h * h) * k)).astype(np.float32)
        self._h_dev = torch.from_numpy(self._h).to(self.device)
        # detection template: pulse-shaped preamble (with tx ramp-up)
        up = np.zeros(preamble.size * k, dtype=np.complex64)
        up[::k] = preamble
        template = np.convolve(up, self._h)[: preamble.size * k]
        self.detector = QDetector(template.astype(np.complex64),
                                  threshold=threshold, dphi_max=dphi_max,
                                  n_dphi=n_dphi, device=self.device)
        self._buf_len = 0

    def set_buf_len(self, n: int) -> None:
        """Cap the number of symbols extracted per detection
        (liquid ``qdsync_cccf_set_buf_len``; qdsync_set_buf_len autotest):
        the default bound of ``execute`` called without ``n_symbols``."""
        if n < self.preamble.shape[0]:
            raise ConfigError(
                f"buffer length ({n}) must be >= preamble length "
                f"({self.preamble.shape[0]})")
        self._buf_len = int(n)

    def get_buf_len(self) -> int:
        return self._buf_len

    def execute(self, x, n_symbols: int | None = None):
        """Search buffer ``x``; return None or ``(symbols, stats)``.

        ``symbols`` (complex64, on the device) starts at the first preamble
        symbol; ``n_symbols`` bounds how many are extracted (default: the
        ``set_buf_len`` cap if set, else as many as the buffer holds).
        ``stats``: rxy, tau, dphi, phi, gamma, evm_db (preamble).
        """
        if n_symbols is None and self._buf_len:
            n_symbols = self._buf_len
        x = _sync.as_samples(x, self.device)
        det = self.detector.detect(x)
        if det is None:
            return None
        y, i0 = _sync.derotate(x, det)
        d = self._h.size - 1
        z_len = x.shape[0] + d
        max_syms = (z_len - 1 - (i0 + d)) // self.k + 1
        nsym = max_syms if n_symbols is None else min(n_symbols, max_syms)
        p = self.preamble
        if nsym < p.shape[0]:
            return None  # buffer too short past the detection point
        syms = _sync.matched_symbols(y, self._h_dev, i0, self.k, nsym)
        # residual carrier: weighted LSQ linear-phase fit on the preamble
        a, b, amp = _sync.phase_fit(syms, p)
        syms = _sync.correct(syms, a, b, amp)
        b, evm = torch.stack([b, _sync.evm_db(syms, p)]).tolist()
        stats = {"rxy": det["rxy"], "tau": det["tau"],
                 "dphi": det["dphi"] + b / self.k, "phi": det["phi"],
                 "gamma": det["gamma"], "evm_db": float(evm)}
        return syms.to(torch.complex64), stats
