"""Analog FM modulator / demodulator.

Port of :mod:`yagi_tpu.modem.freq` (behavioral spec: freqmod.rs, freqdem.rs).
Freqmod: 16-bit wrapping phase accumulator, Δφ = round(kf·2¹⁶·m), 1024-entry
cexp LUT with 10-bit rounded index (freqmod.rs:45-58). Block modulation uses
a cumulative sum of the rounded integer increments, bit-identical to the
per-sample accumulator. Freqdem: m = arg(r'*·r)/(2π·kf) (freqdem.rs:35-43),
a one-lag phase difference that vectorizes with a prepended carried sample.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import last
from ..errors import ConfigError

__all__ = ["Freqmod", "Freqdem"]

_TAB_LEN = 1024


def _cexp_table() -> np.ndarray:
    i = np.arange(_TAB_LEN)
    return np.exp(2j * np.pi * i / _TAB_LEN).astype(np.complex64)


@struct.state
class Freqmod:
    """FM modulator state (freqmod.rs:6-12)."""

    kf: float = struct.static_field()
    table: torch.Tensor = struct.field()  # [1024] cexp LUT
    phase: torch.Tensor = struct.field()  # int64 holding the 16-bit accumulator

    @classmethod
    def create(cls, kf: float, batch_shape: tuple = (), device=None) -> "Freqmod":
        device = resolve_device(device)
        if kf <= 0.0:
            raise ConfigError(f"modulation factor {kf:.4e} must be greater than 0")
        return cls(
            kf=float(kf),
            table=torch.from_numpy(_cexp_table()).to(device),
            phase=torch.zeros(batch_shape, dtype=torch.int64, device=device),
        )

    def reset(self) -> "Freqmod":
        return self.replace(phase=torch.zeros_like(self.phase))

    def modulate(self, m) -> tuple[torch.Tensor, "Freqmod"]:
        """Modulate a block of message samples m [..., N] (freqmod.rs:45).

        Per sample: phase += round(kf·2¹⁶·m) (mod 2¹⁶). The block sums the
        increments in int64 and keeps the low 16 bits, which equals the
        reference's wrapping u32 sum masked to 16 bits. torch.round rounds
        half to even, as jnp.round does.
        """
        m = torch.as_tensor(m, dtype=torch.float32, device=self.phase.device)
        ref = float(np.float32(self.kf * (1 << 16)))  # exact in float32
        inc = torch.round(ref * m).to(torch.int32).to(torch.int64)
        phase16 = (self.phase[..., None] + torch.cumsum(inc, dim=-1)) & 0xFFFF
        index = ((phase16 + 0x0020) >> 6) & 0x03FF
        return self.table[index], self.replace(phase=last(phase16, self.phase))

    modulate_block = modulate
    __call__ = modulate


@struct.state
class Freqdem:
    """FM demodulator state (freqdem.rs:6-9)."""

    kf: float = struct.static_field()
    r_prime: torch.Tensor = struct.field()  # previous received sample, complex64

    @classmethod
    def create(cls, kf: float, batch_shape: tuple = (), device=None) -> "Freqdem":
        device = resolve_device(device)
        if kf <= 0.0:
            raise ConfigError(f"modulation factor {kf:.4e} must be greater than 0")
        return cls(
            kf=float(kf),
            r_prime=torch.zeros(batch_shape, dtype=torch.complex64, device=device),
        )

    def reset(self) -> "Freqdem":
        return self.replace(r_prime=torch.zeros_like(self.r_prime))

    def demodulate(self, r) -> tuple[torch.Tensor, "Freqdem"]:
        """m[n] = arg(conj(r[n-1])·r[n]) / (2π·kf) (freqdem.rs:35).

        r [..., N] complex64; strided views (such as the transposed
        step-major channelizer output) are taken as they are.
        """
        r = torch.as_tensor(r, device=self.r_prime.device)
        prev = torch.cat([self.r_prime[..., None], r[..., :-1]], dim=-1)
        ref = float(np.float32(1.0 / (2.0 * np.pi * self.kf)))
        m = torch.angle(prev.conj() * r) * ref
        # a copy, so the state does not alias the caller's buffer
        return m, self.replace(r_prime=last(r, self.r_prime).clone())

    demodulate_block = demodulate
    __call__ = demodulate
