"""Streaming finite impulse response filter.

Port of :mod:`yagi_tpu.filter.firfilt` (reference: firfilt.rs). A whole
block is filtered in one call of ``kernels/fir.py::fir_block_apply`` over
the block after the carried history: on the card the direct-form kernel
``csrc/fir.cu``, on the CPU its plain version, the banded matmul of
``_conv.py``. The last L inputs are carried in ``window``, so consecutive
blocks equal one long block.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from .. import design
from ..kernels.fir import fir_block_apply, fir_block_reference
from ._conv import np_taps

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

    @classmethod
    def create_rnyquist(
        cls, ftype, k: int, m: int, beta: float, mu: float = 0.0, **kw
    ) -> "FirFilter":
        """(root-)Nyquist prototype (firfilt.rs:112)."""
        return cls.create(design.fir_design_prototype(ftype, k, m, beta, mu), **kw)

    @classmethod
    def create_firdespm(cls, h_len: int, fc: float, as_: float, **kw) -> "FirFilter":
        """Parks-McClellan lowpass, scaled by bandwidth (firfilt.rs:129-134)."""
        h = design.fir_design_pm_lowpass(h_len, fc, as_, 0.0)
        return cls.create(h * (0.5 / fc), **kw)

    @classmethod
    def create_rect(cls, n: int, **kw) -> "FirFilter":
        """Rectangular prototype (firfilt.rs:148)."""
        if n == 0 or n > 1024:
            raise ConfigError("filter length must be in [1,1024]")
        return cls.create(np.ones(n, dtype=np.float32), **kw)

    @classmethod
    def create_dc_blocker(cls, m: int, as_: float, **kw) -> "FirFilter":
        """DC-blocking filter (firfilt.rs:166)."""
        return cls.create(design.fir_design_notch(m, 0.0, as_), **kw)

    @classmethod
    def create_notch(cls, m: int, as_: float, f0: float, dtype=None, **kw) -> "FirFilter":
        """Notch filter; complex dtype mixes a DC blocker to f0 (firfilt.rs:25-43)."""
        if dtype is not None and dtype.is_complex:
            h = design.fir_design_notch(m, 0.0, as_)
            i = np.arange(len(h))
            phi = 2.0 * np.pi * f0 * (i - float(m))
            h = h * np.exp(1j * phi)
            return cls.create(h, dtype=dtype, **kw)
        h = design.fir_design_notch(m, f0, as_)
        return cls.create(h, dtype=dtype, **kw)

    # ------------------------------------------------------------- properties
    @property
    def h_len(self) -> int:
        return self.h.shape[0]

    def __len__(self) -> int:
        return self.h_len

    # ------------------------------------------------------------- streaming
    def reset(self) -> "FirFilter":
        """Clear sample history (firfilt.rs:209)."""
        return self.replace(window=torch.zeros_like(self.window))

    def push(self, x) -> "FirFilter":
        """Push one sample into the history (firfilt.rs:220)."""
        x = torch.as_tensor(x, dtype=self.window.dtype, device=self.window.device)
        x = torch.broadcast_to(x, self.window.shape[:-1])
        return self.replace(window=torch.cat([self.window[..., 1:], x[..., None]], dim=-1))

    def write(self, x) -> "FirFilter":
        """Push a block without producing output (firfilt.rs:230)."""
        x = torch.as_tensor(x, dtype=self.window.dtype, device=self.window.device)
        xa = torch.cat([self.window, x], dim=-1)
        return self.replace(window=carry(self.window, xa))

    def execute(self) -> torch.Tensor:
        """Output for the current window (firfilt.rs:241): Σ h[k]·w[newest-k]."""
        dt = torch.promote_types(self.window.dtype, self.h.dtype)
        y = torch.sum(self.h.flip(0).to(dt) * self.window.to(dt), dim=-1)
        return y * self.scale

    def execute_one(self, x):
        """push + execute (firfilt.rs:256)."""
        q = self.push(x)
        return q.execute(), q

    def execute_block(self, x) -> tuple[torch.Tensor, "FirFilter"]:
        """Filter a block; returns (y, updated filter) (firfilt.rs:267).

        y[..., n] = scale · Σ_k h[k] · x[..., n-k], history crossing block
        boundaries via the carried window.
        """
        return self._run(x, plain=False)

    def _run(self, x, plain: bool):
        """The block through ``fir_block_apply``, or with ``plain`` through
        its plain version on any device (a chain's oracle)."""
        x = torch.as_tensor(x, device=self.window.device)
        fn = fir_block_reference if plain else fir_block_apply
        y = fn(x, self.window, self.h, self.scale)
        return y, self.replace(window=self._carried(x))

    def _carried(self, x: torch.Tensor) -> torch.Tensor:
        """``carry(window, xa)`` without forming xa = (window[..., 1:], x):
        the last L samples of the stream, in x's dtype; a copy, so the state
        neither aliases nor keeps alive the caller's block."""
        n, L = x.shape[-1], self.window.shape[-1]
        if n >= L:
            return x[..., n - L :].clone(memory_format=torch.contiguous_format)
        return torch.cat([self.window[..., n:].to(x.dtype), x], dim=-1)

    __call__ = execute_block

    def set_scale(self, scale) -> "FirFilter":
        return self.replace(
            scale=torch.tensor(scale, dtype=self.h.dtype, device=self.h.device)
        )

    def get_scale(self):
        return self.scale

    def freqresponse(self, fc: float) -> complex:
        """Frequency response at fc, including scale (firfilt.rs:325)."""
        return design.freqresponse(self.h.cpu().numpy(), fc) * complex(self.scale.cpu().numpy())

    def groupdelay(self, fc: float) -> float:
        """Group delay at fc (firfilt.rs:339)."""
        return design.fir_group_delay(self.h.cpu().numpy().real, fc)
