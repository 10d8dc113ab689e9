"""M-ary FSK modulator / demodulator.

Port of :mod:`yagi_tpu.modem.fsk` (behavioral spec: fskmod.rs, fskdem.rs).
Fskmod: per symbol s, tone frequency dφ = (s − (M−1)/2)·2π·bw/((M−1)/2) on
a u32-phase oscillator (fskmod.rs:48-79); block modulation builds the phase
ramp in u32 (int64 masked with ``U32``), one cumulative sum over the
symbols. Fskdem: a K-point FFT per symbol, the peak over the demod map's
bins (fskdem.rs:101-126); every symbol of a block in one batched
``torch.fft.fft``, ties in the peak to the first index as in yagi_tpu.

As in yagi_tpu, ``get_frequency_error`` indexes the spectrum by the
symbol's mapped FFT bin (liquid's behavior), here per channel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.struct import U32
from ..errors import ConfigError, ValueRangeError
from ..nco.osc import PHASE_TO_RAD, constrain_phase

__all__ = ["Fskmod", "Fskdem"]


def _validate(m: int, k: int, bandwidth: float) -> None:
    if m == 0:
        raise ConfigError("bits/symbol must be greater than 0")
    if k < 2 or k > 2048:
        raise ConfigError("samples/symbol must be in [2, 2048]")
    if not (0.0 < bandwidth < 0.5):
        raise ConfigError("bandwidth must be in (0,0.5)")


@struct.state
class Fskmod:
    """FSK modulator state (fskmod.rs:7-13)."""

    m: int = struct.static_field()  # bits/symbol
    k: int = struct.static_field()  # samples/symbol
    bandwidth: float = struct.static_field()
    theta: torch.Tensor = struct.field()  # u32 oscillator phase, int64

    @classmethod
    def create(cls, m: int, k: int, bandwidth: float, batch_shape: tuple = (),
               device=None) -> "Fskmod":
        device = resolve_device(device)
        _validate(m, k, bandwidth)
        return cls(m=m, k=k, bandwidth=float(bandwidth),
                   theta=torch.zeros(batch_shape, dtype=torch.int64, device=device))

    @property
    def m_size(self) -> int:
        return 1 << self.m

    def reset(self) -> "Fskmod":
        return self.replace(theta=torch.zeros_like(self.theta))

    def modulate(self, symbols) -> tuple[torch.Tensor, "Fskmod"]:
        """Symbols [..., S] → complex64 samples [..., S·k] (fskmod.rs:48),
        the u32 phase arithmetic of stepping the reference oscillator."""
        if not isinstance(symbols, torch.Tensor):
            symbols = torch.from_numpy(np.asarray(symbols).astype(np.int64))
        symbols = symbols.to(self.theta.device)
        m2 = 0.5 * (self.m_size - 1)
        dphi = (symbols.to(torch.float32) - m2) * (2.0 * np.pi * self.bandwidth / m2)
        dtheta = constrain_phase(dphi)  # [..., S]
        step = (dtheta * self.k) & U32  # a symbol's advance
        # phase at sample j of symbol i: θ0 + Σ_{i'<i} k·dθ_i' + j·dθ_i
        base = (torch.cumsum(step, -1) - step) & U32
        j = torch.arange(self.k, device=dtheta.device)
        thetas = (self.theta[..., None, None] + base[..., :, None]
                  + j * dtheta[..., :, None]) & U32
        y = torch.exp(1j * (thetas.to(torch.float32) * PHASE_TO_RAD)).to(torch.complex64)
        y = y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))
        return y, self.replace(theta=(self.theta + step.sum(-1)) & U32)

    __call__ = modulate


@struct.state
class Fskdem:
    """FSK demodulator state (fskdem.rs:6-15)."""

    m: int = struct.static_field()
    k: int = struct.static_field()
    k_size: int = struct.static_field()  # FFT size
    demod_map: tuple = struct.static_field()  # symbol → FFT bin
    last_spectrum: torch.Tensor = struct.field()  # [..., k_size] |F| of the last symbol
    s_demod: torch.Tensor = struct.field()  # last demodulated symbol, int32

    @classmethod
    def create(cls, m: int, k: int, bandwidth: float, batch_shape: tuple = (),
               device=None) -> "Fskdem":
        device = resolve_device(device)
        _validate(m, k, bandwidth)
        m_size = 1 << m
        m2 = 0.5 * (m_size - 1)

        # FFT-size search for bin alignment (fskdem.rs:33-53)
        df = bandwidth / m2
        k_min = k
        k_max = min(k * 4, 16)
        k_size = k_min
        err_min = 1e9
        for k_hat in range(k_min, k_max + 1):
            v = 0.5 * df * k_hat
            err = abs(round(v) - v)
            if k_hat == k_min or err < err_min:
                k_size = k_hat
                err_min = err
            if err < 1e-6:
                break

        # tone → bin map (fskdem.rs:56-66)
        demod_map = []
        for i in range(m_size):
            idx = (i - m2) * bandwidth / m2 * k_size
            index = int(round(idx + k_size)) if idx < 0.0 else int(round(idx))
            demod_map.append(index % k_size)
        for i in range(1, m_size):
            if demod_map[i] == demod_map[i - 1]:
                raise ConfigError("demod map is not unique; consider increasing bandwidth")

        return cls(
            m=m, k=k, k_size=k_size, demod_map=tuple(demod_map),
            last_spectrum=torch.zeros(batch_shape + (k_size,), dtype=torch.float32,
                                      device=device),
            s_demod=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        )

    @property
    def m_size(self) -> int:
        return 1 << self.m

    def reset(self) -> "Fskdem":
        return self.replace(last_spectrum=torch.zeros_like(self.last_spectrum),
                            s_demod=torch.zeros_like(self.s_demod))

    def _bins(self) -> torch.Tensor:
        return torch.tensor(self.demod_map, dtype=torch.int64, device=self.s_demod.device)

    def demodulate(self, y) -> tuple[torch.Tensor, "Fskdem"]:
        """Samples [..., S·k] → int32 symbols [..., S] (fskdem.rs:101); a
        trailing partial symbol is dropped, as in yagi_tpu."""
        y = torch.as_tensor(y, device=self.s_demod.device)
        S = y.shape[-1] // self.k
        if S == 0:
            return torch.zeros(y.shape[:-1] + (0,), dtype=torch.int32, device=y.device), self
        frames = y[..., : S * self.k].reshape(y.shape[:-1] + (S, self.k))
        F = torch.fft.fft(frames, n=self.k_size, dim=-1)  # zero-padded to k_size
        mag = F.abs()  # [..., S, k_size]
        syms = torch.argmax(mag[..., self._bins()], dim=-1).to(torch.int32)
        return syms, self.replace(last_spectrum=mag[..., -1, :], s_demod=syms[..., -1])

    __call__ = demodulate

    def get_frequency_error(self) -> torch.Tensor:
        """Adjacent-bin derivative at the last peak (fskdem.rs:128), each
        channel at its own symbol's bin."""
        K = self.k_size
        b = self._bins()[self.s_demod.to(torch.int64)][..., None]
        spec = self.last_spectrum
        vm = torch.gather(spec, -1, (b + K - 1) % K)[..., 0]
        v0 = torch.gather(spec, -1, b)[..., 0]
        vp = torch.gather(spec, -1, (b + 1) % K)[..., 0]
        return (vp - vm) / v0

    def get_symbol_energy(self, s: int, rng: int) -> torch.Tensor:
        """Energy around tone s within ±rng bins (fskdem.rs:140ff)."""
        if s >= self.m_size:
            raise ValueRangeError(f"symbol ({s}) exceeds maximum")
        b = self.demod_map[s]
        idx = [(b + o) % self.k_size for o in range(-rng, rng + 1)]
        return self.last_spectrum[..., idx].square().sum(-1)
