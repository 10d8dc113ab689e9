"""Filter design (reference layer L3), host-side float64 coefficient math.

FIR: windowed-sinc (Kaiser and generic), Parks-McClellan/Remez, the
raised-cosine, flipped-Nyquist and root-Nyquist families, GMSK, hM3, the
notch and DC blocker, doppler, and the filter statistics. IIR: analog
prototypes, bilinear transform, TF and SOS realizations (:mod:`.iir`).
"""

from .fir import *  # noqa: F401,F403
from .iir import *  # noqa: F401,F403
from .pm import (  # noqa: F401
    FirPmBandType,
    FirPmWeightType,
    FirDesignPm,
    fir_design_pm,
    fir_design_pm_lowpass,
)
