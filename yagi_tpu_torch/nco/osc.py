"""Numerically-controlled oscillator, VCO, PLL and block mixers.

Port of :mod:`yagi_tpu.nco.osc`. The phase is a wrapping u32 accumulator
(osc.rs:27-33, constrain osc.rs:191-200), held here as int64 in [0, 2^32)
and masked after every update. Block mixing vectorizes the phase ramp
θ_n = θ0 + n·dθ (mod 2^32), which equals stepping per sample exactly
(osc.rs:161-188). Three synthesis modes, as in yagi_tpu:

  "nco"   — 1024-entry sine table, nearest index (nco.rs:47-51)
  "vco"   — 1024-entry {value, skew} tables, linear interpolation (vco.rs)
  "exact" — sin/cos of the phase, no table

The tables are built in float32 on the host exactly as yagi_tpu builds them
and moved to a device once (:func:`_tables`); the index arithmetic on the
int64-held phase reproduces the u32 shifts and masks bit for bit.
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
_MODES = ("nco", "vco", "exact")
_LUT_BITS = 10
_LUT_SIZE = 1 << _LUT_BITS
_PLL_BANDWIDTH_DEFAULT = 0.1


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


def _nco_table() -> np.ndarray:
    i = np.arange(_LUT_SIZE)
    return np.sin(2.0 * np.pi * i / _LUT_SIZE).astype(np.float32)


def _vco_tables() -> tuple[np.ndarray, np.ndarray]:
    """{value, skew} tables built exactly as vco.rs:34-77."""
    qsize = _LUT_SIZE >> 2
    hsize = _LUT_SIZE >> 1
    value = np.zeros(_LUT_SIZE, dtype=np.float32)
    skew = np.zeros(_LUT_SIZE, dtype=np.float32)

    def fp_sin(theta_u32: int) -> float:
        return np.float32(np.sin(np.float32(theta_u32) * np.pi / 2147483648.0))

    d_theta = 0xFFFFFFFF // _LUT_SIZE
    theta = 0
    for i in range(qsize):
        v = fp_sin(theta)
        nv = fp_sin(theta + d_theta)
        s = (nv - v) / np.float32(d_theta)
        value[i] = v
        skew[i] = s
        value[i + hsize] = -v
        skew[i + hsize] = -s
        theta = (theta + d_theta) & 0xFFFFFFFF

    value[qsize] = 1.0
    skew[qsize] = -skew[qsize - 1]
    value[qsize + hsize] = -1.0
    skew[qsize + hsize] = skew[qsize - 1]
    for i in range(1, qsize):
        value[i + qsize] = value[qsize - i]
        skew[i + qsize] = -skew[qsize - i - 1]
        value[i + qsize + hsize] = -value[qsize - i]
        skew[i + qsize + hsize] = skew[qsize - i - 1]
    return value, skew


_TABLES: dict = {}  # (mode, device) → the mode's tables on that device


def _tables(mode: str, device: torch.device) -> tuple:
    key = (mode, device)
    if key not in _TABLES:
        host = (_nco_table(),) if mode == "nco" else _vco_tables()
        _TABLES[key] = tuple(torch.from_numpy(t).to(device) for t in host)
    return _TABLES[key]


def _sin_cos(theta: torch.Tensor, mode: str = "exact"):
    """(sin, cos) of an int64-held u32 phase in the given synthesis mode.

    The u32 sums wrap at 2^32; here they carry into bit 32, which the shift
    by 22 moves to bit 10 and the 10-bit index mask drops, so no ``U32``
    mask is needed before the shift.
    """
    if mode == "exact":
        t = theta.to(torch.float32) * PHASE_TO_RAD
        return torch.sin(t), torch.cos(t)
    if mode == "nco":
        (tab,) = _tables(mode, theta.device)
        idx = ((theta + (1 << (32 - _LUT_BITS - 1))) >> (32 - _LUT_BITS)) & (_LUT_SIZE - 1)
        idx_pi2 = (idx + (_LUT_SIZE >> 2)) & (_LUT_SIZE - 1)
        return tab[idx], tab[idx_pi2]
    if mode == "vco":
        value, skew = _tables(mode, theta.device)
        accum_mask = (1 << (32 - _LUT_BITS)) - 1

        def interp(th):
            idx = (th >> (32 - _LUT_BITS)) & (_LUT_SIZE - 1)
            acc = (th & accum_mask).to(torch.float32)
            return value[idx] + acc * skew[idx]

        return interp(theta), interp(theta + (1 << 30))
    raise ConfigError(f"unknown oscillator mode {mode!r}")


def _rotate_down(x: torch.Tensor, theta: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """x · e^{−jθ} for a u32 phase θ."""
    s, c = _sin_cos(theta, mode)
    return x * torch.complex(c, -s)


def _rotate_up(x: torch.Tensor, theta: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """x · e^{+jθ} for a u32 phase θ."""
    s, c = _sin_cos(theta, mode)
    return x * torch.complex(c, s)


@struct.state
class Osc:
    """Oscillator state (osc.rs:27-33)."""

    mode: str = struct.static_field()
    theta: torch.Tensor = struct.field()  # u32 phase, int64
    d_theta: torch.Tensor = struct.field()  # u32 frequency, int64
    alpha: torch.Tensor = struct.field()  # PLL bandwidth
    beta: torch.Tensor = struct.field()  # sqrt(bandwidth)

    @classmethod
    def create(cls, mode: str = "nco", batch_shape: tuple = (), device=None) -> "Osc":
        device = resolve_device(device)
        if mode not in _MODES:
            raise ConfigError(f"unknown oscillator mode {mode!r}")
        bw = _PLL_BANDWIDTH_DEFAULT
        return cls(
            mode=mode,
            theta=torch.zeros(batch_shape, dtype=torch.int64, device=device),
            d_theta=torch.zeros(batch_shape, dtype=torch.int64, device=device),
            alpha=torch.full(batch_shape, bw, dtype=torch.float32, device=device),
            beta=torch.full(batch_shape, float(np.float32(np.sqrt(bw))), dtype=torch.float32,
                            device=device),
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
        return self.sin_cos()[0]

    def cos(self) -> torch.Tensor:
        return self.sin_cos()[1]

    def sin_cos(self):
        return _sin_cos(self.theta, self.mode)

    def cexp(self) -> torch.Tensor:
        """exp(jθ) (osc.rs:130)."""
        s, c = self.sin_cos()
        return torch.complex(c, s)

    # ------------------------------------------------------------------- PLL
    def pll_set_bandwidth(self, bw) -> "Osc":
        """2nd-order loop gains α = bw, β = √bw (osc.rs:138-144)."""
        bw = torch.as_tensor(bw, dtype=torch.float32, device=self.theta.device)
        return self.replace(alpha=bw, beta=torch.sqrt(bw))

    def pll_step(self, dphi) -> "Osc":
        """Phase-detector update (osc.rs:147-150): the frequency moves by
        dphi·α, then the phase by dphi·β."""
        dphi = torch.as_tensor(dphi, dtype=torch.float32, device=self.theta.device)
        return self.adjust_frequency(dphi * self.alpha).adjust_phase(dphi * self.beta)

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
        return _rotate_down(torch.as_tensor(x, device=self.theta.device), self.theta, self.mode)

    def mix_block_up(self, x) -> tuple[torch.Tensor, "Osc"]:
        """Block up-mix (osc.rs:161); advances the phase by N samples."""
        x = torch.as_tensor(x, device=self.theta.device)
        n = x.shape[-1]
        return _rotate_up(x, self._phase_ramp(n), self.mode), self._advance(n)

    def mix_block_up_n(self, x, n_valid) -> tuple[torch.Tensor, "Osc"]:
        """Up-mix a fixed-capacity buffer whose first ``n_valid`` samples are
        real; the phase advances by n_valid (variable-rate stages)."""
        x = torch.as_tensor(x, device=self.theta.device)
        return _rotate_up(x, self._phase_ramp(x.shape[-1]), self.mode), self._advance(n_valid)

    def mix_block_down(self, x) -> tuple[torch.Tensor, "Osc"]:
        """Block down-mix (osc.rs:179); advances the phase by N samples."""
        n = x.shape[-1]
        return _rotate_down(x, self._phase_ramp(n), self.mode), self._advance(n)

    def mix_block_down_n(self, x, n_valid) -> tuple[torch.Tensor, "Osc"]:
        """Down-mix a fixed-capacity buffer whose first ``n_valid`` samples
        are real; the phase advances by n_valid (variable-rate stages)."""
        y = _rotate_down(x, self._phase_ramp(x.shape[-1]), self.mode)
        return y, self._advance(n_valid)
