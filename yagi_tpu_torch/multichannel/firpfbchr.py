"""firpfbchr: arbitrary-rate polyphase channelizer analysis bank.

Port of :mod:`yagi_tpu.multichannel.firpfbchr` (behavioral spec: liquid-dsp's
firpfbchr): M channels spaced 1/M apart, decimated by an arbitrary factor
P ≤ M. Each step consumes P input samples and gives one output per channel,
so the channel rate is fs/P, oversampled whenever P < M. A step's output is
the M-point DFT-bank response of the prototype window ending at the newest
sample: the Firpfbch2 sliding transform (``firpfbch._sliding_residue_conv``,
an inverse FFT, the twiddle of the global sample index) with M/2 replaced
by P.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from .. import design
from ..filter.firpfb import pfb_decompose
from .firpfbch import _sliding_residue_conv, _twiddle

__all__ = ["Firpfbchr"]


@struct.state
class Firpfbchr:
    """M-channel, P-decimation analysis channelizer (liquid firpfbchr)."""

    num_channels: int = struct.static_field()
    decim: int = struct.static_field()
    branches: torch.Tensor = struct.field()  # [M, p], branches[b, q] = h[b + qM]
    scale: torch.Tensor = struct.field()  # float32 scalar
    hist: torch.Tensor = struct.field()  # [..., L-1] raw history
    sample_count: torch.Tensor = struct.field()  # int64 0-d: samples consumed, mod M

    @classmethod
    def create(cls, num_channels: int, decim: int, h, batch_shape: tuple = (),
               device=None) -> "Firpfbchr":
        device = resolve_device(device)
        if num_channels < 2:
            raise ConfigError(f"number of channels ({num_channels}) must be >= 2")
        if decim < 1:
            raise ConfigError(f"decimation factor ({decim}) must be >= 1")
        if decim > num_channels:
            raise ConfigError(
                f"decimation factor ({decim}) cannot exceed the number of "
                f"channels ({num_channels})")
        M = num_channels
        branches = pfb_decompose(np.asarray(h, dtype=np.float64), M)
        L = branches.shape[1] * M
        return cls(
            num_channels=M,
            decim=decim,
            branches=torch.from_numpy(branches.astype(np.float32)).to(device),
            scale=torch.tensor(1.0, dtype=torch.float32, device=device),
            hist=torch.zeros(batch_shape + (L - 1,), dtype=torch.complex64, device=device),
            sample_count=torch.zeros((), dtype=torch.int64, device=device),
        )

    @classmethod
    def create_kaiser(cls, num_channels: int, decim: int, m: int = 4, as_: float = 60.0,
                      **kw) -> "Firpfbchr":
        """Kaiser prototype at fc = 0.5/M (liquid firpfbchr kaiser ctor)."""
        if m < 1:
            raise ConfigError(f"filter semi-length ({m}) must be >= 1")
        h_len = 2 * num_channels * m + 1
        h = design.fir_design_kaiser(h_len, 0.5 / num_channels, as_, 0.0)
        return cls.create(num_channels, decim, h[: h_len - 1], **kw)

    @property
    def p(self) -> int:
        return self.branches.shape[1]

    def get_delay(self) -> float:
        """Group delay at the channel rate: (L/2) input samples / P."""
        return (self.p * self.num_channels / 2) / self.decim

    def reset(self) -> "Firpfbchr":
        return self.replace(hist=torch.zeros_like(self.hist),
                            sample_count=torch.zeros_like(self.sample_count))

    def set_scale(self, scale) -> "Firpfbchr":
        return self.replace(
            scale=torch.tensor(float(scale), dtype=torch.float32, device=self.branches.device))

    def analyzer_execute(self, x) -> tuple[torch.Tensor, "Firpfbchr"]:
        """x [..., T·P] → channels [..., M, T]: channel k is the input mixed
        down by k/M, filtered by the prototype and decimated by P."""
        x = torch.as_tensor(x, dtype=torch.complex64, device=self.branches.device)
        M, P = self.num_channels, self.decim
        total = x.shape[-1]
        if total % P:
            raise ConfigError(f"input length must be a multiple of P={P}")
        T = total // P
        L = self.p * M
        if T == 0:  # an empty block: no outputs, the state stands
            return x.new_zeros(x.shape[:-1] + (M, 0)), self

        xa = torch.cat([self.hist, x], dim=-1)  # [..., L-1+T·P]
        c = _sliding_residue_conv(xa, self.branches, P)  # [..., T, M]
        Y = torch.fft.ifft(c, dim=-1, norm="forward")
        t = torch.arange(T, device=x.device)
        e = (t + 1) * P - 1 + self.sample_count
        y = (Y * _twiddle(M, e) * self.scale).transpose(-1, -2)  # [..., M, T]

        new = self.replace(
            hist=carry(self.hist, xa).clone(),
            sample_count=(self.sample_count + T * P) % M,
        )
        return y, new
