"""Transforms (reference layer L2), on ``torch.fft``.

Port of :mod:`yagi_tpu.fft`, with liquid's conventions (the reference's
fft/mod.rs:125-150 test runner): the forward transform is unnormalized
(e^{-j2πkn/N} kernel), and so is the inverse: callers divide by N. yagi_tpu
runs these as XLA ops and has no kernel of its own here, so ``torch.fft`` is
their counterpart; any size (radix-2, composite, prime) is taken.

A tensor argument is transformed on its own device. Anything else (a numpy
array, a list) is placed on ``device``: the card unless the caller asks for
another, through :func:`~yagi_tpu_torch._src.device.resolve_device`.
Double-precision input is taken in single precision, as yagi_tpu's arrays
are (JAX without 64-bit mode).
"""

from __future__ import annotations

import torch

from ..errors import ConfigError
from ._input import as_signal
from .asgram import Asgram  # noqa: F401
from .r2r import dct, dst, r2r_inverse_scale  # noqa: F401
from .spgram import Spgram, spgram_estimate_psd  # noqa: F401
from .spwaterfall import Spwaterfall  # noqa: F401

__all__ = [
    "FFT_FORWARD",
    "FFT_BACKWARD",
    "fft_run",
    "ifft_run",
    "fft_shift",
    "Fft",
    "Spgram",
    "spgram_estimate_psd",
    "Spwaterfall",
    "Asgram",
    "dct",
    "dst",
    "r2r_inverse_scale",
]

FFT_FORWARD = "forward"
FFT_BACKWARD = "backward"


def fft_run(x, direction: str = FFT_FORWARD, device=None) -> torch.Tensor:
    """One-shot transform over the last axis (fft/mod.rs:66).

    Forward: X[k] = Σ x[n] e^{-j2πkn/N}. Backward: the unnormalized inverse
    Σ X[k] e^{+j2πkn/N}; the caller divides by N as the reference tests do
    (fft/mod.rs:139-142).
    """
    x = as_signal(x, device)
    if direction == FFT_FORWARD:
        return torch.fft.fft(x)
    if direction == FFT_BACKWARD:
        return torch.fft.ifft(x, norm="forward")
    raise ConfigError(f"unknown FFT direction {direction!r}")


def ifft_run(x, device=None) -> torch.Tensor:
    """Unnormalized inverse transform (liquid's backward convention)."""
    return fft_run(x, FFT_BACKWARD, device)


def fft_shift(x, device=None) -> torch.Tensor:
    """liquid's fftshift over the last axis (fft/mod.rs:50-57).

    For even N the same as ``torch.fft.fftshift``. For odd N liquid swaps
    the two (N-1)/2 halves and leaves the LAST element in place, which
    differs from numpy's fftshift; kept exactly for parity.
    """
    x = as_signal(x, device)
    n = x.shape[-1]
    if n % 2 == 0:
        return torch.fft.fftshift(x, dim=-1)
    n2 = (n - 1) // 2
    return torch.cat([x[..., n2 : 2 * n2], x[..., :n2], x[..., 2 * n2 :]], dim=-1)


class Fft:
    """Planned-transform object for API parity (fft/mod.rs:34-58).

    ``torch.fft`` plans and caches internally, so this is a thin callable.
    """

    def __init__(self, n: int, direction: str = FFT_FORWARD):
        if n < 1:
            raise ConfigError("fft size must be at least 1")
        if direction not in (FFT_FORWARD, FFT_BACKWARD):
            raise ConfigError(f"unknown FFT direction {direction!r}")
        self.n = n
        self.direction = direction

    def run(self, x, device=None) -> torch.Tensor:
        x = as_signal(x, device)
        if x.shape[-1] != self.n:
            raise ConfigError(f"fft input length {x.shape[-1]} != planned size {self.n}")
        return fft_run(x, self.direction)

    def shift(self, x, device=None) -> torch.Tensor:
        return fft_shift(x, device)

    def __repr__(self) -> str:
        return f"Fft(n={self.n}, direction={self.direction})"
