"""Adaptive equalization (reference layer L5: src/equalization/)."""

from .eqlms import Eqlms  # noqa: F401
from .eqrls import Eqrls  # noqa: F401
