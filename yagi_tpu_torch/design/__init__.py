"""Filter design (host-side float64 coefficient math), the Kaiser path."""

from .fir import *  # noqa: F401,F403
