"""Quantization and companding.

Port of :mod:`yagi_tpu.quantization` (liquid-dsp's compand/quantizer API,
LIQUID_COMPAT.md:1945-1955): μ-law compression and expansion and
fixed-point ADC/DAC quantization, elementwise on tensors of any device.
The ADC codes are int32, equal to yagi_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ConfigError

__all__ = [
    "compress_mulaw",
    "expand_mulaw",
    "quantize_adc",
    "quantize_dac",
    "Quantizer",
]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def compress_mulaw(x, mu: float = 255.0) -> torch.Tensor:
    """μ-law compression: sign(x)·ln(1+μ|x|)/ln(1+μ) (liquid compand).

    Complex inputs compand I and Q independently (liquid
    ``compress_cf_mulaw``).
    """
    if mu <= 0:
        raise ConfigError("mu must be greater than zero")
    x = _tensor(x)
    if x.is_complex():
        return torch.complex(compress_mulaw(x.real, mu), compress_mulaw(x.imag, mu))
    return torch.sign(x) * torch.log1p(mu * x.abs()) / float(np.log1p(mu))


def expand_mulaw(y, mu: float = 255.0) -> torch.Tensor:
    """μ-law expansion (inverse of compression)."""
    if mu <= 0:
        raise ConfigError("mu must be greater than zero")
    y = _tensor(y)
    if y.is_complex():
        return torch.complex(expand_mulaw(y.real, mu), expand_mulaw(y.imag, mu))
    return torch.sign(y) * (torch.exp(y.abs() * float(np.log1p(mu))) - 1.0) / mu


def _scale(num_bits: int) -> int:
    if num_bits < 1 or num_bits > 24:
        raise ConfigError("number of bits must be in [1,24]")
    return 1 << (num_bits - 1)


def quantize_adc(x, num_bits: int) -> torch.Tensor:
    """Uniform quantization of x ∈ [-1, 1) to signed int32 codes (liquid
    qtype ADC)."""
    scale = _scale(num_bits)
    x = _tensor(x)
    return torch.floor(x.clamp(-1.0, 1.0 - 1.0 / scale) * scale).to(torch.int32)


def quantize_dac(q, num_bits: int) -> torch.Tensor:
    """Integer codes → float32 midpoint values (liquid qtype DAC)."""
    scale = _scale(num_bits)
    return (_tensor(q).to(torch.float32) + 0.5) / scale


class Quantizer:
    """Compander + fixed-point quantizer (liquid quantizer object)."""

    def __init__(self, num_bits: int, compander: str = "none", mu: float = 255.0):
        if compander not in ("none", "mulaw"):
            raise ConfigError(f"unknown compander {compander!r}")
        _scale(num_bits)  # validates num_bits
        self.num_bits = num_bits
        self.compander = compander
        self.mu = mu

    def execute_adc(self, x) -> torch.Tensor:
        if self.compander == "mulaw":
            x = compress_mulaw(x, self.mu)
        return quantize_adc(x, self.num_bits)

    def execute_dac(self, q) -> torch.Tensor:
        y = quantize_dac(q, self.num_bits)
        if self.compander == "mulaw":
            y = expand_mulaw(y, self.mu)
        return y
