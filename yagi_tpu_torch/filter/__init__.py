"""Streaming filters (reference layer L4), the subset the ported slice needs."""

from .firfilt import FirFilter  # noqa: F401
from .firpfb import pfb_decompose  # noqa: F401
from .resamp import Resamp  # noqa: F401
