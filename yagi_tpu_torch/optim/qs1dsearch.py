"""Derivative-free 1-D quadratic-sectioning search (host-side float64).

Copied from :mod:`yagi_tpu.optim.qs1dsearch` (the reference's
optim/qs1dsearch.rs), used by the rkaiser and PM-halfband filter designs.
"""

from __future__ import annotations

import enum
from typing import Callable

from ..errors import ConfigError, NoConvergenceError

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
        self.reset()

    def reset(self) -> None:
        self.vn = self.v0 = self.vp = 0.0
        self.un = self.u0 = self.up = 0.0
        self.initialized = False
        self.num_steps = 0

    def _better(self, a: float, b: float) -> bool:
        if self.direction == OptimDirection.MINIMIZE:
            return a < b
        return a > b

    def init(self, v: float) -> None:
        """Expanding-step bracket initialization from a point (qs1dsearch.rs:73)."""
        for step in (1e-16, -1e-16):
            if self._init_direction(v, step):
                return
        # edge case: v is already the optimum
        step = 1e-16
        un = self.utility(v - step)
        u0 = self.utility(v)
        up = self.utility(v + step)
        if self._better(u0, un) and self._better(u0, up):
            self.vn, self.v0, self.vp = v - step, v, v + step
            self.un, self.u0, self.up = un, u0, up
            self.initialized = True
            return
        raise NoConvergenceError("qs1dsearch: failed to initialize search")

    def _init_direction(self, v_init: float, step: float) -> bool:
        v0 = v_init
        vp = v_init + step * 0.5
        u0 = self.utility(v0)
        up = self.utility(vp)
        for _ in range(180):
            vn, v0 = v0, vp
            un, u0 = u0, up
            vp = v0 + step
            up = self.utility(vp)
            if self._better(u0, un) and self._better(u0, up):
                swap = step < 0.0
                self.vn, self.v0, self.vp = (vp, v0, vn) if swap else (vn, v0, vp)
                self.un, self.u0, self.up = (up, u0, un) if swap else (un, u0, up)
                self.initialized = True
                return True
            if self._better(un, u0) and self._better(u0, up):
                break  # clearly moving in the wrong direction
            step *= 1.5
        return False

    def init_bounds(self, vn: float, vp: float) -> None:
        """Bracket initialization from explicit bounds (qs1dsearch.rs:149)."""
        self.vn, self.vp = min(vn, vp), max(vn, vp)
        self.v0 = 0.5 * (vn + vp)
        self.un = self.utility(self.vn)
        self.u0 = self.utility(self.v0)
        self.up = self.utility(self.vp)
        self.initialized = True

    def step(self) -> None:
        """One sectioning step (qs1dsearch.rs:165)."""
        if not self.initialized:
            raise ConfigError("qs1dsearch: not initialized")
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
        self.num_steps += 1

    def execute(self) -> None:
        """API parity no-op (qs1dsearch.rs:212-214)."""
        return None

    def get_num_steps(self) -> int:
        return self.num_steps

    def get_opt_v(self) -> float:
        return self.v0

    def get_opt_u(self) -> float:
        return self.u0
