"""FIR filter design (host-side float64), the Kaiser path.

Copied from :mod:`yagi_tpu.design.fir`, which also holds the Parks-McClellan
and Nyquist designs; only the Kaiser windowed-sinc is ported, so this module
needs neither the optimizer nor the Remez code.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError
from ..math import windows as mwin
from ..math.special import sincf

__all__ = ["fir_design_kaiser", "kaiser_beta_stopband_attenuation"]


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
