"""Host-side design math (float64 NumPy), the subset the ported slice needs."""

from .special import *  # noqa: F401,F403
from .windows import *  # noqa: F401,F403
