"""Streaming finite impulse response filter.

Port of :mod:`yagi_tpu.filter.firfilt` (reference: firfilt.rs). A whole
block is filtered with one batched convolution over ``concat(history, x)``;
the last L inputs are carried in ``window``, so consecutive blocks equal one
long block.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from .. import design
from ._conv import causal_conv_valid, np_taps

__all__ = ["FirFilter"]


@struct.state
class FirFilter:
    """FIR filter state (reference struct firfilt.rs:10-15)."""

    h: torch.Tensor = struct.field()  # [L] taps; h[0] multiplies newest sample
    scale: torch.Tensor = struct.field()  # output scaling (firfilt.rs:285)
    window: torch.Tensor = struct.field()  # [..., L] last L inputs, oldest..newest

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(
        cls, h, scale=1.0, batch_shape: tuple = (), dtype=None, device=None
    ) -> "FirFilter":
        """From explicit coefficients (firfilt.rs:63)."""
        device = resolve_device(device)
        h = np_taps(h)
        if h.size == 0:
            raise ConfigError("filter length must be greater than zero")
        if dtype is None:
            dtype = torch.complex64 if np.iscomplexobj(h) else torch.float32
        ht = torch.from_numpy(h).to(device)
        return cls(
            h=ht,
            scale=torch.tensor(scale, dtype=ht.dtype, device=device),
            window=torch.zeros(batch_shape + (len(h),), dtype=dtype, device=device),
        )

    @classmethod
    def create_kaiser(
        cls, n: int, fc: float, as_: float, mu: float = 0.0, **kw
    ) -> "FirFilter":
        """Kaiser windowed-sinc lowpass (firfilt.rs:93)."""
        return cls.create(design.fir_design_kaiser(n, fc, as_, mu), **kw)

    # ------------------------------------------------------------- streaming
    def execute_block(self, x) -> tuple[torch.Tensor, "FirFilter"]:
        """Filter a block; returns (y, updated filter) (firfilt.rs:267).

        y[..., n] = scale · Σ_k h[k] · x[..., n-k], history crossing block
        boundaries via the carried window.
        """
        xa = torch.cat([self.window[..., 1:].to(x.dtype), x], dim=-1)
        y = causal_conv_valid(xa, self.h) * self.scale
        return y, self.replace(window=xa[..., xa.shape[-1] - self.h.shape[0] :])

    __call__ = execute_block

    def set_scale(self, scale) -> "FirFilter":
        return self.replace(
            scale=torch.tensor(scale, dtype=self.h.dtype, device=self.h.device)
        )
