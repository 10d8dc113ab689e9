"""Overlap-add frequency-domain FIR filter.

Port of :mod:`yagi_tpu.filter.fftfilt` (reference: fftfilt.rs). Fixed block
size n, 2n-point FFT, Y = X·H, IFFT, add the saved tail, save the new tail
(fftfilt.rs:103-138), on ``torch.fft`` as yagi_tpu does it on ``jnp.fft``;
several blocks go through one batched FFT.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ._conv import np_taps

__all__ = ["FftFilt"]


@struct.state
class FftFilt:
    """Overlap-add state (fftfilt.rs:22-38)."""

    n: int = struct.static_field()  # block size
    h_len: int = struct.static_field()
    real_io: bool = struct.static_field()  # rrrf variant returns the real part
    h_freq: torch.Tensor = struct.field()  # [2n] filter spectrum
    scale: torch.Tensor = struct.field()  # includes the 1/(2n) inverse normalization
    w: torch.Tensor = struct.field()  # [..., n] saved overlap tail

    @classmethod
    def create(cls, h, n: int, batch_shape: tuple = (), dtype=None, device=None) -> "FftFilt":
        """Precompute H = FFT(h, 2n) (fftfilt.rs:46-83)."""
        device = resolve_device(device)
        h = np_taps(h)
        h_len = len(h)
        if h_len == 0:
            raise ConfigError("filter length must be greater than zero")
        if n < h_len - 1:
            raise ConfigError(f"block length must be greater than h_len-1 ({h_len - 1})")
        if dtype is None:
            dtype = torch.complex64 if np.iscomplexobj(h) else torch.float32
        h_freq = np.fft.fft(h.astype(np.complex64), 2 * n).astype(np.complex64)
        return cls(
            n=n,
            h_len=h_len,
            real_io=not dtype.is_complex,
            h_freq=torch.from_numpy(h_freq).to(device),
            scale=torch.tensor(1.0 / (2.0 * n), dtype=torch.float32, device=device),
            w=torch.zeros(batch_shape + (n,), dtype=torch.complex64, device=device),
        )

    def reset(self) -> "FftFilt":
        return self.replace(w=torch.zeros_like(self.w))

    def set_scale(self, scale) -> "FftFilt":
        """The stored scale folds in the 1/(2n) inverse normalization (fftfilt.rs:95)."""
        s = torch.as_tensor(scale, dtype=torch.float32, device=self.scale.device)
        return self.replace(scale=s / (2.0 * self.n))

    def get_scale(self):
        return self.scale * (2.0 * self.n)

    def _spectra(self, xb: torch.Tensor) -> torch.Tensor:
        """[..., n] blocks → the 2n-point filtered blocks, unnormalized as
        liquid's backward transform (the scale carries 1/(2n))."""
        xt = torch.cat([xb.to(torch.complex64), torch.zeros_like(xb, dtype=torch.complex64)], -1)
        return torch.fft.ifft(torch.fft.fft(xt, dim=-1) * self.h_freq, dim=-1, norm="forward")

    def execute(self, x) -> tuple[torch.Tensor, "FftFilt"]:
        """Filter one n-sample block (fftfilt.rs:103-138)."""
        x = torch.as_tensor(x, device=self.w.device)
        if x.shape[-1] != self.n:
            raise ConfigError("input length must match filter block size")
        yt = self._spectra(x)
        y = (yt[..., : self.n] + self.w) * self.scale
        if self.real_io:
            y = y.real
        return y, self.replace(w=yt[..., self.n :])

    __call__ = execute

    def execute_blocks(self, x) -> tuple[torch.Tensor, "FftFilt"]:
        """Filter x of length k·n: the k FFTs batched, the overlap-add chained
        by a shifted add (the only dependency between blocks is the tail)."""
        x = torch.as_tensor(x, device=self.w.device)
        total = x.shape[-1]
        if total % self.n != 0:
            raise ConfigError("input length must be a multiple of the block size")
        if total == 0:  # an empty block: no outputs, the tail stands
            dt = torch.float32 if self.real_io else torch.complex64
            return torch.zeros(x.shape, dtype=dt, device=x.device), self
        k = total // self.n
        Y = self._spectra(x.reshape(x.shape[:-1] + (k, self.n)))
        heads, tails = Y[..., : self.n], Y[..., self.n :]
        prev = torch.cat([self.w[..., None, :], tails[..., :-1, :]], dim=-2)
        y = ((heads + prev) * self.scale).reshape(x.shape[:-1] + (total,))
        if self.real_io:
            y = y.real
        return y, self.replace(w=tails[..., -1, :])

    def get_length(self) -> int:
        return self.h_len
