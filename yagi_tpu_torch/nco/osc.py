"""Numerically-controlled oscillator and block mixers, mode ``"exact"``.

Port of :mod:`yagi_tpu.nco.osc`. The phase is a wrapping u32 accumulator
(osc.rs:27-33, constrain osc.rs:191-200), held here as int64 in [0, 2^32)
and masked after every update. Block mixing vectorizes the phase ramp
θ_n = θ0 + n·dθ (mod 2^32), which equals stepping per sample exactly
(osc.rs:161-188).

Only the ``"exact"`` synthesis mode (sin/cos of the phase, no table) is
ported, with its controls and single-sample and block mixers, without the
PLL; the ``"nco"`` and ``"vco"`` lookup-table modes raise
:class:`ConfigError` until they are.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.struct import U32
from ..errors import ConfigError

__all__ = ["Osc", "constrain_phase"]

_TWO_PI = 2.0 * np.pi
_TWO_PI_F32 = float(np.float32(_TWO_PI))
# u32 phase → radians, the float32 constant of osc.py:105 and chain.py:160
PHASE_TO_RAD = float(np.float32(_TWO_PI / 4294967296.0))
_PORTED_MODES = ("exact",)


def constrain_phase(theta, device=None) -> torch.Tensor:
    """radians → wrapping u32 phase as int64 (osc.rs:191-200).

    Float32 throughout, with the same floored modulo (fmod plus sign fix) and
    the same saturating float→u32 conversion as the reference, so the result
    is bit-identical. A tensor stays on its device unless ``device`` is
    given; anything else goes to ``resolve_device(device)``.
    """
    if device is not None or not isinstance(theta, torch.Tensor):
        device = resolve_device(device)
    t = torch.as_tensor(theta, dtype=torch.float32, device=device)
    two_pi = torch.tensor(_TWO_PI_F32, dtype=torch.float32, device=t.device)
    r = torch.fmod(t, two_pi)
    r = torch.where(r < 0, r + two_pi, r)  # floored modulo, as jnp.mod
    u = r / two_pi * 4294967296.0
    return u.to(torch.int64).clamp(0, U32)


def _sin_cos(theta: torch.Tensor):
    """(sin, cos) of an int64-held u32 phase, mode "exact"."""
    t = theta.to(torch.float32) * PHASE_TO_RAD
    return torch.sin(t), torch.cos(t)


def _rotate_down(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """x · e^{−jθ} for a u32 phase θ."""
    s, c = _sin_cos(theta)
    return x * torch.complex(c, -s)


def _rotate_up(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """x · e^{+jθ} for a u32 phase θ."""
    s, c = _sin_cos(theta)
    return x * torch.complex(c, s)


@struct.state
class Osc:
    """Oscillator state (osc.rs:27-33)."""

    mode: str = struct.static_field()
    theta: torch.Tensor = struct.field()  # u32 phase, int64
    d_theta: torch.Tensor = struct.field()  # u32 frequency, int64

    @classmethod
    def create(cls, mode: str = "nco", batch_shape: tuple = (), device=None) -> "Osc":
        device = resolve_device(device)
        if mode not in ("nco", "vco", "exact"):
            raise ConfigError(f"unknown oscillator mode {mode!r}")
        if mode not in _PORTED_MODES:
            raise ConfigError(
                f"oscillator mode {mode!r} is not ported yet; use 'exact'"
            )
        return cls(
            mode=mode,
            theta=torch.zeros(batch_shape, dtype=torch.int64, device=device),
            d_theta=torch.zeros(batch_shape, dtype=torch.int64, device=device),
        )

    # ----------------------------------------------------------------- control
    def reset(self) -> "Osc":
        return self.replace(theta=torch.zeros_like(self.theta),
                            d_theta=torch.zeros_like(self.d_theta))

    def set_frequency(self, dtheta) -> "Osc":
        """Frequency in radians/sample (osc.rs:66)."""
        return self.replace(d_theta=constrain_phase(dtheta, self.theta.device))

    def adjust_frequency(self, df) -> "Osc":
        return self.replace(d_theta=(self.d_theta + constrain_phase(df, self.theta.device)) & U32)

    def set_phase(self, phi) -> "Osc":
        return self.replace(theta=constrain_phase(phi, self.theta.device))

    def adjust_phase(self, dphi) -> "Osc":
        return self.replace(theta=(self.theta + constrain_phase(dphi, self.theta.device)) & U32)

    def step(self) -> "Osc":
        """Advance one sample (osc.rs:86)."""
        return self._advance(1)

    def get_phase(self) -> torch.Tensor:
        """Phase in [0, 2π) (osc.rs:91)."""
        return self.theta.to(torch.float32) * PHASE_TO_RAD

    def get_frequency(self) -> torch.Tensor:
        """Frequency in (-π, π] (osc.rs:96)."""
        d = self.d_theta.to(torch.float32) * PHASE_TO_RAD
        return torch.where(d > np.pi, d - _TWO_PI, d)

    # ------------------------------------------------------------- synthesis
    def sin(self) -> torch.Tensor:
        return _sin_cos(self.theta)[0]

    def cos(self) -> torch.Tensor:
        return _sin_cos(self.theta)[1]

    def sin_cos(self):
        return _sin_cos(self.theta)

    def cexp(self) -> torch.Tensor:
        """exp(jθ) (osc.rs:130)."""
        s, c = _sin_cos(self.theta)
        return torch.complex(c, s)

    # ---------------------------------------------------------------- mixing
    def _phase_ramp(self, n: int) -> torch.Tensor:
        idx = torch.arange(n, dtype=torch.int64, device=self.theta.device)
        return (self.theta[..., None] + idx * self.d_theta[..., None]) & U32

    def _advance(self, n) -> "Osc":
        return self.replace(theta=(self.theta + n * self.d_theta) & U32)

    def mix_up(self, x) -> torch.Tensor:
        """Single-sample up-mix (osc.rs:155)."""
        return torch.as_tensor(x, device=self.theta.device) * self.cexp()

    def mix_down(self, x) -> torch.Tensor:
        """Single-sample down-mix (osc.rs:173)."""
        return _rotate_down(torch.as_tensor(x, device=self.theta.device), self.theta)

    def mix_block_up(self, x) -> tuple[torch.Tensor, "Osc"]:
        """Block up-mix (osc.rs:161); advances the phase by N samples."""
        x = torch.as_tensor(x, device=self.theta.device)
        n = x.shape[-1]
        return _rotate_up(x, self._phase_ramp(n)), self._advance(n)

    def mix_block_up_n(self, x, n_valid) -> tuple[torch.Tensor, "Osc"]:
        """Up-mix a fixed-capacity buffer whose first ``n_valid`` samples are
        real; the phase advances by n_valid (variable-rate stages)."""
        x = torch.as_tensor(x, device=self.theta.device)
        return _rotate_up(x, self._phase_ramp(x.shape[-1])), self._advance(n_valid)

    def mix_block_down(self, x) -> tuple[torch.Tensor, "Osc"]:
        """Block down-mix (osc.rs:179); advances the phase by N samples."""
        n = x.shape[-1]
        return _rotate_down(x, self._phase_ramp(n)), self._advance(n)

    def mix_block_down_n(self, x, n_valid) -> tuple[torch.Tensor, "Osc"]:
        """Down-mix a fixed-capacity buffer whose first ``n_valid`` samples
        are real; the phase advances by n_valid (variable-rate stages)."""
        y = _rotate_down(x, self._phase_ramp(x.shape[-1]))
        return y, self._advance(n_valid)
