"""Spectral-mask (PSD region) validation helpers.

Copied from :mod:`yagi_tpu.utils.psd_validate` (behavioral spec: the
reference's utility/test_helpers.rs:10-137): run a signal or a frequency
response, FFT it, and assert dB bounds per frequency region. Host-side
NumPy; :func:`validate_psd_spgram` takes a port :class:`~yagi_tpu_torch.fft.Spgram`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..errors import ConfigError
from ..math.special import nextpow2

__all__ = [
    "PsdRegion",
    "validate_psd_spectrum",
    "validate_psd_signal",
    "validate_psd_signalf",
    "validate_psd_spgram",
]


@dataclasses.dataclass(frozen=True)
class PsdRegion:
    """Frequency region with optional lower/upper dB bounds (test_helpers.rs:10)."""

    fmin: float
    fmax: float
    pmin: float = 0.0
    pmax: float = 0.0
    test_lo: bool = False
    test_hi: bool = False


def validate_psd_spectrum(psd, nfft: int, regions) -> bool:
    """Check a (fft-shifted, dB) spectrum against regions (test_helpers.rs:19)."""
    psd = np.asarray(psd)
    f = np.arange(nfft) / nfft - 0.5
    ok = True
    for region in regions:
        if region.fmin < -0.5 or region.fmax > 0.5 or region.fmin > region.fmax:
            raise ConfigError("invalid frequency range")
        in_region = (f >= region.fmin) & (f <= region.fmax)
        if region.test_lo:
            ok &= not np.any(in_region & (psd < region.pmin))
        if region.test_hi:
            ok &= not np.any(in_region & (psd > region.pmax))
    return bool(ok)


def validate_psd_signal(buf, regions) -> bool:
    """FFT a complex signal, shift, convert to dB, validate (test_helpers.rs:54)."""
    buf = np.asarray(buf)
    nfft = 4 << nextpow2(max(len(buf), 64))
    spec = np.fft.fft(buf, nfft)
    psd = 20.0 * np.log10(np.abs(np.fft.fftshift(spec)) + 1e-30)
    return validate_psd_spectrum(psd, nfft, regions)


def validate_psd_signalf(buf, regions) -> bool:
    """Real-signal variant (test_helpers.rs:77)."""
    return validate_psd_signal(np.asarray(buf, dtype=np.complex64), regions)


def validate_psd_spgram(spgram, regions) -> bool:
    """Validate a Spgram's accumulated PSD (test_helpers.rs:130)."""
    psd = spgram.get_psd().cpu().numpy()
    return validate_psd_spectrum(psd, spgram.nfft, regions)
