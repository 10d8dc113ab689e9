"""Derivative-free 1-D quadratic-sectioning search.

Copied from :mod:`yagi_tpu.optim.qs1dsearch` (qs1dsearch.rs), the bracketed
form the PM-halfband design uses (``init_bounds`` then ``step``). Host-side
float64.
"""

from __future__ import annotations

import enum
from typing import Callable

__all__ = ["OptimDirection", "Qs1dSearch"]


class OptimDirection(enum.Enum):
    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"


class Qs1dSearch:
    """Bisection-style sectioning search over a unimodal 1-D utility.

    Maintains a bracket (vn, v0, vp); each :meth:`step` evaluates the two
    midpoints and shrinks the bracket around the optimum (qs1dsearch.rs:165).
    """

    def __init__(
        self,
        utility: Callable[[float], float],
        direction: OptimDirection = OptimDirection.MINIMIZE,
    ):
        self.utility = utility
        self.direction = direction

    def _better(self, a: float, b: float) -> bool:
        if self.direction == OptimDirection.MINIMIZE:
            return a < b
        return a > b

    def init_bounds(self, vn: float, vp: float) -> None:
        """Bracket initialization from explicit bounds (qs1dsearch.rs:149)."""
        self.vn, self.vp = min(vn, vp), max(vn, vp)
        self.v0 = 0.5 * (vn + vp)
        self.un = self.utility(self.vn)
        self.u0 = self.utility(self.v0)
        self.up = self.utility(self.vp)

    def step(self) -> None:
        """One sectioning step (qs1dsearch.rs:165)."""
        va = 0.5 * (self.vn + self.v0)
        vb = 0.5 * (self.v0 + self.vp)
        ua = self.utility(va)
        ub = self.utility(vb)

        if self._better(ua, self.u0) and self._better(ua, ub):
            self.vp, self.up = self.v0, self.u0
            self.v0, self.u0 = va, ua
        elif self._better(self.u0, ua) and self._better(self.u0, ub):
            self.vn, self.un = va, ua
            self.vp, self.up = vb, ub
        else:
            self.vn, self.un = self.v0, self.u0
            self.v0, self.u0 = vb, ub

    def get_opt_v(self) -> float:
        return self.v0
