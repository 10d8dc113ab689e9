"""Polyphase filter bank.

Port of :mod:`yagi_tpu.filter.firpfb` (reference: firpfb.rs). The prototype
filter h (length M·Lsub) is decomposed so branch i computes
y_i[t] = Σ_j h[i + j·M] · x[t-j]; branches are stored in convolution order.
A shared input window is carried in the state; a branch is chosen by an int
or a 0-d integer tensor (a gather over the branch axis, no host read).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from .. import design
from ._conv import causal_conv_valid, multi_branch_conv, np_taps, result_dtype

__all__ = ["FirPfbFilter", "pfb_decompose"]


def pfb_decompose(h: np.ndarray, num_filters: int) -> np.ndarray:
    """[M·Lsub] prototype → [M, Lsub] branch matrix, convolution order.

    branches[i, j] = h[i + j·M]; truncates any trailing remainder exactly as
    the reference's h_sub_len = h_len // num_filters (firpfb.rs:42).
    """
    h = np.asarray(h)
    sub_len = len(h) // num_filters
    return np.stack(
        [h[i : i + sub_len * num_filters : num_filters] for i in range(num_filters)]
    )


@struct.state
class FirPfbFilter:
    """PFB state (reference struct firpfb.rs:10-15)."""

    branches: torch.Tensor = struct.field()  # [M, Lsub] convolution order
    scale: torch.Tensor = struct.field()
    window: torch.Tensor = struct.field()  # [..., Lsub] oldest..newest

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(
        cls, num_filters: int, h, scale=1.0, batch_shape: tuple = (), dtype=None, device=None
    ) -> "FirPfbFilter":
        """From prototype coefficients (firpfb.rs:34)."""
        device = resolve_device(device)
        if num_filters == 0:
            raise ConfigError("number of filters must be greater than zero")
        h = np_taps(h)
        if h.size == 0:
            raise ConfigError("filter length must be greater than zero")
        branches = pfb_decompose(h, num_filters)
        if dtype is None:
            dtype = torch.complex64 if np.iscomplexobj(h) else torch.float32
        bt = torch.from_numpy(branches).to(device)
        return cls(
            branches=bt,
            scale=torch.tensor(scale, dtype=bt.dtype, device=device),
            window=torch.zeros(batch_shape + (branches.shape[1],), dtype=dtype, device=device),
        )

    @classmethod
    def create_default(cls, num_filters: int, m: int, **kw) -> "FirPfbFilter":
        """Default Kaiser design (firpfb.rs:79)."""
        return cls.create_kaiser(num_filters, m, 0.5, 60.0, **kw)

    @classmethod
    def create_kaiser(
        cls, num_filters: int, m: int, fc: float, as_: float, **kw
    ) -> "FirPfbFilter":
        """Kaiser prototype, h_len = 2·M·m+1 (firpfb.rs:95)."""
        if num_filters == 0:
            raise ConfigError("number of filters must be greater than zero")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if fc <= 0.0 or fc > 0.5:
            raise ConfigError("filter cut-off frequency must be in (0,0.5)")
        if as_ < 0.0:
            raise ConfigError("stop-band attenuation must be non-negative")
        h_len = 2 * num_filters * m + 1
        h = design.fir_design_kaiser(h_len, fc / num_filters, as_, 0.0)
        return cls.create(num_filters, h, **kw)

    @classmethod
    def create_rnyquist(
        cls, ftype, num_filters: int, k: int, m: int, beta: float, **kw
    ) -> "FirPfbFilter":
        """Root-Nyquist prototype oversampled by the bank size (firpfb.rs:121ff)."""
        h = design.fir_design_prototype(ftype, k * num_filters, m, beta, 0.0)
        return cls.create(num_filters, h, **kw)

    @classmethod
    def create_drnyquist(
        cls, ftype, num_filters: int, k: int, m: int, beta: float, **kw
    ) -> "FirPfbFilter":
        """Derivative root-Nyquist bank for timing recovery (firpfb.rs:163-196):
        dh[i] = h[i+1] - h[i-1], circular at the ends."""
        h = design.fir_design_prototype(ftype, k * num_filters, m, beta, 0.0)
        dh = np.roll(h, -1) - np.roll(h, 1)
        return cls.create(num_filters, dh, **kw)

    # ------------------------------------------------------------- properties
    @property
    def num_filters(self) -> int:
        return self.branches.shape[0]

    @property
    def sub_len(self) -> int:
        return self.branches.shape[1]

    # ------------------------------------------------------------- streaming
    def reset(self) -> "FirPfbFilter":
        return self.replace(window=torch.zeros_like(self.window))

    def push(self, x) -> "FirPfbFilter":
        """Push one sample (firpfb.rs:255)."""
        x = torch.as_tensor(x, dtype=self.window.dtype, device=self.window.device)
        x = torch.broadcast_to(x, self.window.shape[:-1])
        return self.replace(window=torch.cat([self.window[..., 1:], x[..., None]], dim=-1))

    def write(self, x) -> "FirPfbFilter":
        """Push a block (firpfb.rs:264)."""
        x = torch.as_tensor(x, dtype=self.window.dtype, device=self.window.device)
        return self.replace(window=carry(self.window, torch.cat([self.window, x], dim=-1)))

    def _branch(self, i) -> torch.Tensor:
        i = torch.as_tensor(i, dtype=torch.int64, device=self.branches.device)
        return self.branches.index_select(0, i.reshape(1))[0]

    def execute(self, i) -> torch.Tensor:
        """Branch-i output for the current window (firpfb.rs:277)."""
        hb = self._branch(i)
        dt = result_dtype(self.window.dtype, hb.dtype)
        return torch.sum(hb.flip(0).to(dt) * self.window.to(dt), dim=-1) * self.scale

    def execute_block(self, i, x) -> tuple[torch.Tensor, "FirPfbFilter"]:
        """Per-sample push+execute with a fixed branch (firpfb.rs:295)."""
        x = torch.as_tensor(x, device=self.window.device)
        xa = torch.cat([self.window[..., 1:].to(x.dtype), x], dim=-1)
        y = causal_conv_valid(xa, self._branch(i)) * self.scale
        return y, self.replace(window=carry(self.window, xa))

    def execute_all(self, x) -> tuple[torch.Tensor, "FirPfbFilter"]:
        """All M branch outputs for a whole block at once: ([..., M, N],
        state), one banded matmul; the building block of the interpolator."""
        x = torch.as_tensor(x, device=self.window.device)
        xa = torch.cat([self.window[..., 1:].to(x.dtype), x], dim=-1)
        y = multi_branch_conv(xa, self.branches) * self.scale
        return y, self.replace(window=carry(self.window, xa))

    def set_scale(self, scale) -> "FirPfbFilter":
        return self.replace(
            scale=torch.tensor(scale, dtype=self.branches.dtype, device=self.branches.device))

    def get_scale(self):
        return self.scale
