"""FIR interpolator (1:M) on a polyphase bank.

Port of :mod:`yagi_tpu.filter.firinterp` (reference: firinterp.rs). Each
input sample produces M outputs, one per PFB branch (firinterp.rs:222-230).
The block path computes every branch for every input with one banded matmul
(:meth:`FirPfbFilter.execute_all`) and interleaves:
y[..., n·M + i] = branch_i at input n.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from ..errors import ConfigError
from .. import design
from .firpfb import FirPfbFilter

__all__ = ["FirInterpolationFilter"]


@struct.state
class FirInterpolationFilter:
    """Interpolator state (firinterp.rs:9-13)."""

    interp: int = struct.static_field()
    pfb: FirPfbFilter = struct.field()

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, interp: int, h, **kw) -> "FirInterpolationFilter":
        """From external coefficients, zero-padded to a multiple of M
        (firinterp.rs:36-60)."""
        if interp < 2:
            raise ConfigError("interp factor must be greater than 1")
        h = np.asarray(h)
        if len(h) < interp:
            raise ConfigError("filter length cannot be less than interp factor")
        sub_len = -(-len(h) // interp)
        h_padded = np.zeros(interp * sub_len, dtype=h.dtype)
        h_padded[: len(h)] = h
        return cls(interp=interp, pfb=FirPfbFilter.create(interp, h_padded, **kw))

    @classmethod
    def create_kaiser(cls, interp: int, m: int, as_: float, **kw):
        """Kaiser prototype; drops the last tap like the reference
        (firinterp.rs:74-90 passes h_len-1)."""
        if interp < 2:
            raise ConfigError("interp factor must be greater than 1")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if as_ < 0.0:
            raise ConfigError("stop-band attenuation must be positive")
        h_len = 2 * interp * m + 1
        h = design.fir_design_kaiser(h_len, 0.5 / interp, as_, 0.0)
        return cls.create(interp, h[: h_len - 1], **kw)

    @classmethod
    def create_prototype(cls, ftype, interp: int, m: int, beta: float, dt: float = 0.0, **kw):
        """(root-)Nyquist prototype (firinterp.rs:106-123)."""
        if interp < 2:
            raise ConfigError("interp factor must be greater than 1")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if beta < 0.0 or beta > 1.0:
            raise ConfigError("filter excess bandwidth factor must be in [0,1]")
        if dt < -1.0 or dt > 1.0:
            raise ConfigError("filter fractional sample delay must be in [-1,1]")
        h = design.fir_design_prototype(ftype, interp, m, beta, dt)
        return cls.create(interp, h, **kw)

    @classmethod
    def create_linear(cls, interp: int, **kw):
        """Linear interpolator (firinterp.rs:135-147)."""
        if interp < 2:
            raise ConfigError("interp factor must be greater than 1")
        i = np.arange(interp, dtype=np.float64)
        h = np.concatenate([i / interp, 1.0 - i / interp])
        return cls.create(interp, h, **kw)

    @classmethod
    def create_window(cls, interp: int, m: int, **kw):
        """sin² window interpolator (firinterp.rs:158-174)."""
        if interp < 2:
            raise ConfigError("interp factor must be greater than 1")
        if m < 1:
            raise ConfigError("filter semi-length must be greater than 0")
        h_len = 2 * m * interp
        i = np.arange(h_len, dtype=np.float64)
        h = np.sin(np.pi * i / h_len) ** 2
        return cls.create(interp, h, **kw)

    # ------------------------------------------------------------- streaming
    @property
    def sub_len(self) -> int:
        return self.pfb.sub_len

    def reset(self):
        return self.replace(pfb=self.pfb.reset())

    def execute(self, x):
        """One input → M outputs (firinterp.rs:222)."""
        x = torch.as_tensor(x, device=self.pfb.window.device)
        return self.execute_block(x[..., None])

    def execute_block(self, x) -> tuple[torch.Tensor, "FirInterpolationFilter"]:
        """Block of N inputs → N·M outputs (firinterp.rs:238)."""
        yb, pfb = self.pfb.execute_all(x)  # [..., M, N]
        y = yb.transpose(-1, -2)  # [..., N, M]
        y = y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))
        return y, self.replace(pfb=pfb)

    __call__ = execute_block

    def set_scale(self, scale):
        return self.replace(pfb=self.pfb.set_scale(scale))

    def get_scale(self):
        return self.pfb.get_scale()
