"""Gradient and quasi-Newton multi-dimensional searches (host-side float64).

Copied from :mod:`yagi_tpu.optim.gradsearch` (liquid-dsp's ``gradsearch`` /
``qnsearch`` optim objects); they run at design/configuration time, not on
the sample path.

Semantics follow liquid's optim conventions: numerically estimated gradient
(central differences), normalized descent direction with momentum
(gradsearch), and a BFGS inverse-Hessian update with backtracking line
search (qnsearch). Both support minimize/maximize via
:class:`~yagi_tpu_torch.optim.qs1dsearch.OptimDirection`.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..errors import ConfigError
from .qs1dsearch import OptimDirection

__all__ = ["GradSearch", "QnSearch"]


def _numgrad(u: Callable, v: np.ndarray, delta: float) -> np.ndarray:
    g = np.zeros_like(v)
    for i in range(v.size):
        vp = v.copy()
        vm = v.copy()
        vp[i] += delta
        vm[i] -= delta
        g[i] = (u(vp) - u(vm)) / (2.0 * delta)
    return g


class GradSearch:
    """Momentum gradient search over an n-dimensional utility.

    liquid gradsearch model: per step, estimate the gradient numerically,
    normalize it, and move by ``gamma`` along it (sign per direction) with
    momentum ``alpha``; ``gamma`` contracts when a step fails to improve.
    """

    def __init__(
        self,
        utility: Callable[[np.ndarray], float],
        v0: Sequence[float],
        direction: OptimDirection = OptimDirection.MINIMIZE,
        delta: float = 1e-6,
        gamma: float = 2e-3,
        alpha: float = 0.1,
    ):
        if delta <= 0 or gamma <= 0:
            raise ConfigError("delta and gamma must be positive")
        self.utility = utility
        self.v = np.asarray(v0, dtype=np.float64).copy()
        self.direction = direction
        self.delta = float(delta)
        self.gamma = float(gamma)
        self.alpha = float(alpha)
        self._p = np.zeros_like(self.v)  # momentum term
        self.u = float(utility(self.v))
        self.num_steps = 0

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.direction == OptimDirection.MINIMIZE else a > b

    def step(self) -> float:
        """One search step; returns the current utility."""
        g = _numgrad(self.utility, self.v, self.delta)
        norm = np.linalg.norm(g)
        if norm > 0:
            g = g / norm
        sign = -1.0 if self.direction == OptimDirection.MINIMIZE else 1.0
        self._p = self.alpha * self._p + sign * self.gamma * g
        v_new = self.v + self._p
        u_new = float(self.utility(v_new))
        if self._better(u_new, self.u):
            self.v, self.u = v_new, u_new
        else:
            # failed step: contract step size, kill momentum (liquid's
            # gamma_hat decay behavior)
            self.gamma *= 0.99
            self._p[:] = 0.0
        self.num_steps += 1
        return self.u

    def execute(self, max_iters: int = 1000, tol: float = 1e-6) -> np.ndarray:
        """Run until the utility improves by < tol over 10 steps (or max_iters)."""
        last = self.u
        stall = 0
        for _ in range(max_iters):
            u = self.step()
            if abs(u - last) < tol:
                stall += 1
                if stall >= 10:
                    break
            else:
                stall = 0
            last = u
        return self.v


class QnSearch:
    """Quasi-Newton (BFGS) search with numerical gradients.

    liquid qnsearch model: maintain an inverse-Hessian estimate B, step along
    ``-B·g`` with a backtracking line search, update B by the BFGS rank-two
    formula.
    """

    def __init__(
        self,
        utility: Callable[[np.ndarray], float],
        v0: Sequence[float],
        direction: OptimDirection = OptimDirection.MINIMIZE,
        delta: float = 1e-6,
    ):
        if delta <= 0:
            raise ConfigError("delta must be positive")
        self.utility = utility
        self.v = np.asarray(v0, dtype=np.float64).copy()
        self.direction = direction
        self.delta = float(delta)
        self.B = np.eye(self.v.size)
        self.u = float(utility(self.v))
        self._g = self._grad(self.v)
        self.num_steps = 0

    def _f(self, v: np.ndarray) -> float:
        u = float(self.utility(v))
        return u if self.direction == OptimDirection.MINIMIZE else -u

    def _grad(self, v: np.ndarray) -> np.ndarray:
        return _numgrad(self._f, v, self.delta)

    def step(self) -> float:
        d = -self.B @ self._g
        # backtracking line search
        t = 1.0
        f0 = self._f(self.v)
        gd = float(self._g @ d)
        for _ in range(30):
            if self._f(self.v + t * d) <= f0 + 1e-4 * t * gd:
                break
            t *= 0.5
        s = t * d
        v_new = self.v + s
        g_new = self._grad(v_new)
        y = g_new - self._g
        sy = float(s @ y)
        if sy > 1e-12:
            rho = 1.0 / sy
            eye = np.eye(self.v.size)
            self.B = (eye - rho * np.outer(s, y)) @ self.B @ (
                eye - rho * np.outer(y, s)
            ) + rho * np.outer(s, s)
        self.v, self._g = v_new, g_new
        self.u = float(self.utility(self.v))
        self.num_steps += 1
        return self.u

    def execute(self, max_iters: int = 200, tol: float = 1e-10) -> np.ndarray:
        for _ in range(max_iters):
            self.step()
            if np.linalg.norm(self._g) < tol:
                break
        return self.v
