"""Host-side design math (float64 NumPy), the subset the ported slices need."""

from .poly import *  # noqa: F401,F403
from .special import *  # noqa: F401,F403
from .windows import *  # noqa: F401,F403
