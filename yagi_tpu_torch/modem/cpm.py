"""Continuous-phase modems: GMSK and CPFSK.

Port of :mod:`yagi_tpu.modem.cpm` (liquid-dsp's ``gmskmod``/``gmskdem``
and ``cpfskmod``/``cpfskdem``): a symbol stream drives a frequency pulse
(Gaussian for GMSK; square, raised-cosine full or partial, or Gaussian for
CPFSK with modulation index h); the transmitted signal is exp(jθ) where θ
integrates the pulse-shaped instantaneous frequency. Demodulation is
non-coherent: the frequency discriminator arg(y·conj(y')), the receive
matched filter, then symbol-rate decisions.

Block math as in yagi_tpu: the zero-stuffed symbols convolved with the
pulse (the port's banded matmul, :func:`~yagi_tpu_torch.filter._conv.
causal_conv_valid`, its index table built on the device) and one
cumulative sum for the phase. The carried state (phase, the last received
sample, the filter windows) makes block splits equal one long block; an
empty block keeps it (:mod:`~yagi_tpu_torch._src.window`).

The Gaussian pulses are :func:`~yagi_tpu_torch.design.fir_design_gmsktx`
and ``gmskrx`` (design/gmsk.rs:20,66).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry, last
from ..design import fir as fir_design
from ..errors import ConfigError
from ..filter._conv import causal_conv_valid

__all__ = ["GmskMod", "GmskDem", "CpfskMod", "CpfskDem", "CpfskFilterType"]


def _stream_conv(window: torch.Tensor, up: torch.Tensor, h: torch.Tensor):
    """Streaming valid convolution: y[n] = Σ_k h[k]·seq[n + Lh − 1 − k] over
    seq = concat(window, up). Returns (y [..., N], the new window [..., Lh−1])."""
    seq = torch.cat([window.to(up.dtype), up], -1)
    return causal_conv_valid(seq, h), carry(window, seq)


def _zero_stuff(v: torch.Tensor, k: int) -> torch.Tensor:
    """[..., S] → [..., S·k] with v at every k-th sample, zeros between."""
    up = torch.zeros(v.shape + (k,), dtype=v.dtype, device=v.device)
    up[..., 0] = v
    return up.reshape(v.shape[:-1] + (v.shape[-1] * k,))


def _as_long(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int64))
    return x.to(device)


def _integrate(theta0: torch.Tensor, dtheta: torch.Tensor):
    """(exp(jθ) complex64, the last θ) with θ = θ0 + cumsum(dθ)."""
    theta = theta0[..., None] + torch.cumsum(dtheta, -1)
    y = torch.exp(1j * theta).to(torch.complex64)
    return y, last(theta, theta0)


def _discriminate(prev: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """arg(y[n]·conj(y[n−1])), the carried sample before the first."""
    shifted = torch.cat([prev[..., None], y[..., :-1]], -1)
    return torch.angle(y * shifted.conj())


def _validate_gmsk(k: int, m: int, bt: float) -> None:
    if k < 2:
        raise ConfigError(f"samples/symbol ({k}) must be >= 2")
    if m < 1:
        raise ConfigError(f"filter delay ({m}) must be >= 1")
    if not 0.0 < bt < 1.0:
        raise ConfigError(f"bandwidth-time product ({bt}) must be in (0,1)")


@struct.state
class GmskMod:
    """GMSK modulator (liquid ``gmskmod``): k samples/symbol, m symbol
    delay, bandwidth-time product bt. The phase moves ±π/2 per bit (MSK),
    shaped by the Gaussian pulse."""

    k: int = struct.static_field()
    m: int = struct.static_field()
    bt: float = struct.static_field()
    h: torch.Tensor = struct.field()  # tx frequency pulse [2km+1]
    theta: torch.Tensor = struct.field()  # carried phase
    window: torch.Tensor = struct.field()  # upsampled-symbol history [2km]

    @classmethod
    def create(cls, k: int = 2, m: int = 3, bt: float = 0.3, batch_shape: tuple = (),
               device=None) -> "GmskMod":
        device = resolve_device(device)
        _validate_gmsk(k, m, bt)
        h = torch.from_numpy(fir_design.fir_design_gmsktx(k, m, bt, 0.0).astype(np.float32))
        return cls(
            k=k, m=m, bt=float(bt), h=h.to(device),
            theta=torch.zeros(batch_shape, dtype=torch.float32, device=device),
            window=torch.zeros(batch_shape + (h.shape[0] - 1,), dtype=torch.float32,
                               device=device),
        )

    def reset(self) -> "GmskMod":
        return self.replace(theta=torch.zeros_like(self.theta),
                            window=torch.zeros_like(self.window))

    def modulate(self, bits) -> tuple[torch.Tensor, "GmskMod"]:
        """Bits [..., S] in {0, 1} → complex64 samples [..., S·k]; output
        symbol j is centered m symbols after input symbol j."""
        v = 2.0 * _as_long(bits, self.h.device).to(torch.float32) - 1.0  # NRZ
        f, window = _stream_conv(self.window, _zero_stuff(v, self.k), self.h)
        # gmsktx integrates to π·k/2 per unit symbol; /k makes it π/2
        y, theta = _integrate(self.theta, f / float(self.k))
        return y, self.replace(theta=theta, window=window)

    __call__ = modulate


@struct.state
class GmskDem:
    """GMSK demodulator (liquid ``gmskdem``): frequency discriminator,
    Gaussian receive matched filter, sign decision at symbol rate. The
    latency from modulator to decisions is 2m symbols."""

    k: int = struct.static_field()
    m: int = struct.static_field()
    bt: float = struct.static_field()
    h: torch.Tensor = struct.field()  # rx filter [2km+1]
    prev: torch.Tensor = struct.field()  # last received sample (discriminator)
    window: torch.Tensor = struct.field()  # frequency-signal history [2km]

    @classmethod
    def create(cls, k: int = 2, m: int = 3, bt: float = 0.3, batch_shape: tuple = (),
               device=None) -> "GmskDem":
        device = resolve_device(device)
        _validate_gmsk(k, m, bt)
        h = torch.from_numpy(fir_design.fir_design_gmskrx(k, m, bt, 0.0).astype(np.float32))
        return cls(
            k=k, m=m, bt=float(bt), h=h.to(device),
            prev=torch.ones(batch_shape, dtype=torch.complex64, device=device),
            window=torch.zeros(batch_shape + (h.shape[0] - 1,), dtype=torch.float32,
                               device=device),
        )

    def reset(self) -> "GmskDem":
        return self.replace(prev=torch.ones_like(self.prev), window=torch.zeros_like(self.window))

    def demodulate(self, y) -> tuple[torch.Tensor, "GmskDem"]:
        """Samples [..., S·k] → uint8 bits [..., S] (delayed by 2m symbols)."""
        y = torch.as_tensor(y, device=self.h.device).to(torch.complex64)
        z, window = _stream_conv(self.window, _discriminate(self.prev, y), self.h)
        bits = (z[..., :: self.k] > 0).to(torch.uint8)
        return bits, self.replace(prev=last(y, self.prev), window=window)

    __call__ = demodulate


# ---------------------------------------------------------------- CPFSK
class CpfskFilterType:
    """Frequency-pulse shapes (liquid LIQUID_CPFSK_*)."""

    SQUARE = "square"
    RCOS_FULL = "rcos-full"
    RCOS_PARTIAL = "rcos-partial"
    GMSK = "gmsk"

    ALL = (SQUARE, RCOS_FULL, RCOS_PARTIAL, GMSK)


def _cpfsk_pulse(ftype: str, k: int, m: int, beta: float) -> np.ndarray:
    """Frequency pulse normalized so its sum is k: after the modulator's /k
    a unit-level symbol advances the phase by π·h_index."""
    if ftype == CpfskFilterType.SQUARE:
        h = np.ones(k, dtype=np.float64)
    elif ftype == CpfskFilterType.RCOS_FULL:
        n = np.arange(k, dtype=np.float64)
        h = 1.0 - np.cos(2.0 * np.pi * (n + 0.5) / k)
    elif ftype == CpfskFilterType.RCOS_PARTIAL:
        # partial response: a raised cosine spanning 2 symbols (L = 2 CPM)
        n = np.arange(2 * k, dtype=np.float64)
        h = 1.0 - np.cos(2.0 * np.pi * (n + 0.5) / (2 * k))
    elif ftype == CpfskFilterType.GMSK:
        h = fir_design.fir_design_gmsktx(k, m, beta, 0.0).astype(np.float64)
    else:
        raise ConfigError(f"unknown cpfsk filter type '{ftype}'")
    return (h * (k / np.sum(h))).astype(np.float32)


def _validate_cpfsk(bps: int, h_index: float, ftype: str) -> None:
    if bps < 1 or bps > 8:
        raise ConfigError(f"bits/symbol ({bps}) must be in [1,8]")
    if h_index <= 0.0:
        raise ConfigError(f"modulation index ({h_index}) must be > 0")
    if ftype not in CpfskFilterType.ALL:
        raise ConfigError(f"unknown cpfsk filter type '{ftype}'")


@struct.state
class CpfskMod:
    """CPFSK modulator (liquid ``cpfskmod``): bps bits/symbol, modulation
    index h_index, k samples/symbol, delay m, pulse beta, filter type."""

    bps: int = struct.static_field()
    h_index: float = struct.static_field()
    k: int = struct.static_field()
    m: int = struct.static_field()
    beta: float = struct.static_field()
    ftype: str = struct.static_field()
    p: torch.Tensor = struct.field()  # frequency pulse
    theta: torch.Tensor = struct.field()
    window: torch.Tensor = struct.field()

    @classmethod
    def create(cls, bps: int = 1, h_index: float = 0.5, k: int = 4, m: int = 3,
               beta: float = 0.35, ftype: str = CpfskFilterType.SQUARE,
               batch_shape: tuple = (), device=None) -> "CpfskMod":
        device = resolve_device(device)
        _validate_cpfsk(bps, h_index, ftype)
        if k < 2:
            raise ConfigError(f"samples/symbol ({k}) must be >= 2")
        if m < 1:
            raise ConfigError(f"filter delay ({m}) must be >= 1")
        p = _cpfsk_pulse(ftype, k, m, beta)
        return cls(
            bps=bps, h_index=float(h_index), k=k, m=m, beta=float(beta), ftype=ftype,
            p=torch.from_numpy(p).to(device),
            theta=torch.zeros(batch_shape, dtype=torch.float32, device=device),
            window=torch.zeros(batch_shape + (p.shape[0] - 1,), dtype=torch.float32,
                               device=device),
        )

    @property
    def m_size(self) -> int:
        return 1 << self.bps

    def reset(self) -> "CpfskMod":
        return self.replace(theta=torch.zeros_like(self.theta),
                            window=torch.zeros_like(self.window))

    def modulate(self, symbols) -> tuple[torch.Tensor, "CpfskMod"]:
        """Symbols [..., S] in [0, 2^bps) → complex64 samples [..., S·k]."""
        s = _as_long(symbols, self.p.device)
        v = 2.0 * s.to(torch.float32) - (self.m_size - 1)  # NRZ level
        f, window = _stream_conv(self.window, _zero_stuff(v, self.k), self.p)
        y, theta = _integrate(self.theta, f * float(np.float32(np.pi * self.h_index / self.k)))
        return y, self.replace(theta=theta, window=window)

    __call__ = modulate


@struct.state
class CpfskDem:
    """CPFSK demodulator: discriminator, pulse matched filter, nearest-level
    decision; decisions lag the modulator by ``delay_syms`` symbols."""

    bps: int = struct.static_field()
    h_index: float = struct.static_field()
    k: int = struct.static_field()
    m: int = struct.static_field()
    beta: float = struct.static_field()
    ftype: str = struct.static_field()
    delay_syms: int = struct.static_field()
    offset: int = struct.static_field()  # decision sample offset in [0, k)
    gain: float = struct.static_field()  # per-unit-level decision gain
    p: torch.Tensor = struct.field()  # rx matched filter (pulse / k)
    prev: torch.Tensor = struct.field()
    window: torch.Tensor = struct.field()

    @classmethod
    def create(cls, bps: int = 1, h_index: float = 0.5, k: int = 4, m: int = 3,
               beta: float = 0.35, ftype: str = CpfskFilterType.SQUARE,
               batch_shape: tuple = (), device=None) -> "CpfskDem":
        device = resolve_device(device)
        _validate_cpfsk(bps, h_index, ftype)
        p = _cpfsk_pulse(ftype, k, m, beta)
        # decision calibration: one unit-level symbol through the tx pulse
        # (as instantaneous frequency), then the rx matched filter; decide at
        # the response's peak, where a full-response pulse has no ISI
        f_tx = p.astype(np.float64) * (np.pi * h_index / k)
        resp = np.convolve(f_tx, p.astype(np.float64) / k)
        peak = int(np.argmax(resp))
        return cls(
            bps=bps, h_index=float(h_index), k=k, m=m, beta=float(beta), ftype=ftype,
            delay_syms=peak // k, offset=peak % k, gain=float(resp[peak]),
            p=torch.from_numpy(p / np.float32(k)).to(device),
            prev=torch.ones(batch_shape, dtype=torch.complex64, device=device),
            window=torch.zeros(batch_shape + (p.shape[0] - 1,), dtype=torch.float32,
                               device=device),
        )

    @property
    def m_size(self) -> int:
        return 1 << self.bps

    def reset(self) -> "CpfskDem":
        return self.replace(prev=torch.ones_like(self.prev), window=torch.zeros_like(self.window))

    def demodulate(self, y) -> tuple[torch.Tensor, "CpfskDem"]:
        """Samples [..., S·k] → int32 symbols [..., S] (delayed delay_syms)."""
        y = torch.as_tensor(y, device=self.p.device).to(torch.complex64)
        z, window = _stream_conv(self.window, _discriminate(self.prev, y), self.p)
        # the estimated NRZ level at the calibrated peak offset
        d = z[..., self.offset:: self.k] / float(np.float32(self.gain))
        sym = torch.round(0.5 * (d + (self.m_size - 1))).clamp(0, self.m_size - 1)
        return sym.to(torch.int32), self.replace(prev=last(y, self.prev), window=window)

    __call__ = demodulate
