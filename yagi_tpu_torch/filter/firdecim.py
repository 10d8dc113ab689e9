"""FIR decimator (M:1).

Port of :mod:`yagi_tpu.filter.firdecim` (reference: firdecim.rs). The
reference pushes M samples and computes one dotprod per group, aligned so
the output for group n is the full filter with x[n·M] as the newest sample
(firdecim.rs:179-190: output computed after the FIRST push of the group).
Here: one strided correlation (``causal_conv_valid`` at stride M).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from .. import design
from ._conv import causal_conv_valid, np_taps

__all__ = ["FirDecimationFilter"]


@struct.state
class FirDecimationFilter:
    """Decimator state (firdecim.rs:10-16)."""

    decim: int = struct.static_field()
    h: torch.Tensor = struct.field()  # [L] taps, h[0] multiplies newest sample
    scale: torch.Tensor = struct.field()
    window: torch.Tensor = struct.field()  # [..., L-1] history before block

    @classmethod
    def create(cls, decim: int, h, scale=1.0, batch_shape: tuple = (), dtype=None,
               device=None) -> "FirDecimationFilter":
        """From explicit coefficients (firdecim.rs:38)."""
        device = resolve_device(device)
        if decim == 0:
            raise ConfigError("decimation factor must be greater than zero")
        h = np_taps(h)
        if h.size == 0:
            raise ConfigError("filter length must be greater than zero")
        if dtype is None:
            dtype = torch.complex64 if np.iscomplexobj(h) else torch.float32
        ht = torch.from_numpy(h).to(device)
        return cls(
            decim=decim,
            h=ht,
            scale=torch.tensor(scale, dtype=ht.dtype, device=device),
            window=torch.zeros(batch_shape + (len(h) - 1,), dtype=dtype, device=device),
        )

    @classmethod
    def create_kaiser(cls, decim: int, m: int, as_: float, **kw):
        """Kaiser anti-aliasing prototype (firdecim.rs:71)."""
        if decim < 2:
            raise ConfigError("decim factor must be greater than 1")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if as_ < 0.0:
            raise ConfigError("stop-band attenuation must be positive")
        h_len = 2 * decim * m + 1
        h = design.fir_design_kaiser(h_len, 0.5 / decim, as_, 0.0)
        return cls.create(decim, h, **kw)

    @classmethod
    def create_prototype(cls, ftype, decim: int, m: int, beta: float, dt: float = 0.0, **kw):
        """(root-)Nyquist prototype (firdecim.rs:102)."""
        if decim < 2:
            raise ConfigError("decimation factor must be greater than 1")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if beta < 0.0 or beta > 1.0:
            raise ConfigError("filter excess bandwidth factor must be in [0,1]")
        if dt < -1.0 or dt > 1.0:
            raise ConfigError("filter fractional sample delay must be in [-1,1]")
        h = design.fir_design_prototype(ftype, decim, m, beta, dt)
        return cls.create(decim, h, **kw)

    @property
    def h_len(self) -> int:
        return self.h.shape[0]

    def reset(self):
        return self.replace(window=torch.zeros_like(self.window))

    def execute_block(self, x) -> tuple[torch.Tensor, "FirDecimationFilter"]:
        """x of length n·M → n outputs (firdecim.rs:192-205).

        y[..., n] = scale · Σ_k h[k] · x[..., n·M - k]  (newest = x[n·M]).
        """
        x = torch.as_tensor(x, device=self.window.device)
        if x.shape[-1] % self.decim != 0:
            raise ConfigError(
                f"input length {x.shape[-1]} must be a multiple of decim {self.decim}"
            )
        xa = torch.cat([self.window.to(x.dtype), x], dim=-1)
        y = causal_conv_valid(xa, self.h, stride=self.decim) * self.scale
        return y, self.replace(window=carry(self.window, xa))

    __call__ = execute_block

    def execute(self, x):
        """One group of M samples → one output (firdecim.rs:179)."""
        return self.execute_block(x)

    def set_scale(self, scale):
        return self.replace(scale=torch.tensor(scale, dtype=self.h.dtype, device=self.h.device))

    def get_scale(self):
        return self.scale

    def freqresp(self, fc: float) -> complex:
        """Frequency response (firdecim.rs:163)."""
        return design.freqresponse(self.h.cpu().numpy(), fc) * complex(self.scale.cpu().numpy())
