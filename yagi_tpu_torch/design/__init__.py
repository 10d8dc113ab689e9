"""Filter design (host-side float64 coefficient math): Kaiser, (root-)raised
cosine and the PM halfband."""

from .fir import *  # noqa: F401,F403
