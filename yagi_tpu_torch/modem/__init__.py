"""Modulation / demodulation (reference layer L6), the analog FM pair."""

from .freq import Freqmod, Freqdem  # noqa: F401
