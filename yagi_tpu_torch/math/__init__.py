"""Math substrate (reference layer L0): host-side design math in float64
NumPy and Python ints (special functions, windows, polynomials, modular
arithmetic), and the tensor-valued complex helpers and ``dotprod``."""

from .special import *  # noqa: F401,F403
from .windows import *  # noqa: F401,F403
from .poly import *  # noqa: F401,F403
from .modarith import *  # noqa: F401,F403
from .complexm import *  # noqa: F401,F403
from .dot import dotprod  # noqa: F401
