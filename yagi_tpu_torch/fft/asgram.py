"""asgram: ASCII spectral periodogram (a terminal waterfall line).

Port of :mod:`yagi_tpu.fft.asgram` (behavioral spec: liquid-dsp's
asgram_crcf): push samples into a periodogram, then render the current PSD
as one line of characters, each binning the spectrum into a display level
against a reference level and a scale, plus the peak frequency and level.
Built on :class:`~.spgram.Spgram`; rendering is a host-side quantization of
the PSD vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ConfigError
from .spgram import Spgram

__all__ = ["Asgram"]

_DEFAULT_LEVELS = " .,-+*&NM#"


class Asgram:
    """ASCII spectrogram over an ``nfft``-point periodogram."""

    def __init__(self, nfft: int, levels: str = _DEFAULT_LEVELS, device=None):
        if nfft < 2:
            raise ConfigError(f"fft size ({nfft}) must be >= 2")
        if len(levels) < 2:
            raise ConfigError("display levels must have >= 2 characters")
        self.nfft = nfft
        self.levels = levels
        self.ref = -40.0  # reference level [dB]
        self.div = 10.0  # dB per display division
        self._sp = Spgram.create(nfft, device=device)

    def set_display(self, ref: float, div: float) -> None:
        """Set reference level [dB] and dB per division (liquid
        ``asgram_set_scale``)."""
        if div <= 0.0:
            raise ConfigError(f"scale ({div}) must be > 0")
        self.ref = float(ref)
        self.div = float(div)

    def reset(self) -> None:
        self._sp = self._sp.reset()

    def push(self, x) -> None:
        """Push samples into the periodogram."""
        self._sp = self._sp.write(torch.as_tensor(x).to(torch.complex64))

    def execute(self) -> tuple[str, float, float]:
        """Render: returns (ascii line, peak frequency in [-0.5, 0.5), peak
        PSD dB)."""
        psd = self._sp.get_psd().cpu().numpy()  # fft-shifted dB
        q = np.clip(np.floor((psd - self.ref) / self.div).astype(int), 0, len(self.levels) - 1)
        line = "".join(self.levels[v] for v in q)
        ipk = int(np.argmax(psd))
        return line, float(ipk / self.nfft - 0.5), float(psd[ipk])
