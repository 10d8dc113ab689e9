"""Modulation / demodulation (reference layer L6): the linear modem and the
analog FM pair."""

from .modem import Modem, ModulationScheme, gray_decode, gray_encode  # noqa: F401
from .freq import Freqmod, Freqdem  # noqa: F401
