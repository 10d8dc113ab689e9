"""Host-side optimizers (float64), the subset filter design needs."""

from .qs1dsearch import OptimDirection, Qs1dSearch  # noqa: F401
