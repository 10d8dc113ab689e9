"""Filter design (host-side float64 coefficient math): Kaiser, (root-)raised
cosine, the PM halfband and lowpass, the notch, and the IIR family (analog
prototypes, bilinear transform, TF and SOS realizations, :mod:`.iir`)."""

from .fir import *  # noqa: F401,F403
from .iir import *  # noqa: F401,F403
from .pm import fir_design_pm_lowpass  # noqa: F401
