"""Streaming filters (reference layer L4)."""

from .farrow import AutoCorr, Dds, FirFarrow  # noqa: F401
from .fftfilt import FftFilt  # noqa: F401
from .firdecim import FirDecimationFilter  # noqa: F401
from .firfilt import FirFilter  # noqa: F401
from .firhilb import FirHilbertFilter  # noqa: F401
from .firinterp import FirInterpolationFilter  # noqa: F401
from .firpfb import FirPfbFilter, pfb_decompose  # noqa: F401
from .iirfilt import IirFilter  # noqa: F401
from .iirfiltsos import IirFilterSos  # noqa: F401
from .iirhilb import IirDecimationFilter, IirHilbertFilter, IirInterpolationFilter  # noqa: F401
from .misc import Fdelay, OrdFilt, design_lpc, levinson  # noqa: F401
from .msresamp import MsResamp  # noqa: F401
from .msresamp2 import MsResamp2  # noqa: F401
from .resamp import Resamp  # noqa: F401
from .resamp2 import Resamp2  # noqa: F401
from .rresamp import Rresamp  # noqa: F401
from .symsync import Symsync  # noqa: F401
