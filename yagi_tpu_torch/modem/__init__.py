"""Modulation / demodulation (reference layer L6: src/modem/): the linear
modem, analog FM, FSK, the continuous-phase modems (GMSK, CPFSK) and AM."""

from .modem import Modem, ModulationScheme, gray_decode, gray_encode  # noqa: F401
from .freq import Freqmod, Freqdem  # noqa: F401
from .fsk import Fskmod, Fskdem  # noqa: F401
from .cpm import (  # noqa: F401
    GmskMod, GmskDem, CpfskMod, CpfskDem, CpfskFilterType,
)
from .ampmodem import AmpModem, AmpModemType  # noqa: F401
