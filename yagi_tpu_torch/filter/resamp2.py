"""Halfband 2× interpolator/decimator, the valid-prefix block forms.

Port of :mod:`yagi_tpu.filter.resamp2` (reference: resamp2.rs). The PM
halfband prototype (4m+1 taps, even outer taps zero) splits into a pure delay
branch (the center tap) and an odd-tap filter branch h1 (resamp2.rs:44-84);
decimation routes even samples through h1 and odd ones through the delay
(resamp2.rs:153), interpolation emits the delay branch then h1
(resamp2.rs:165). State: the two 2m-sample branch windows.

Only the valid-prefix forms that :class:`~yagi_tpu_torch.filter.MsResamp2`
chains are ported (``interp_execute_block_n``, ``decim_execute_block_n``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from .. import design
from ._conv import causal_conv_valid

__all__ = ["Resamp2"]


@struct.state
class Resamp2:
    """Halfband resampler state (resamp2.rs:25-36)."""

    m: int = struct.static_field()
    h1: torch.Tensor = struct.field()  # [2m] branch taps, conv order
    scale: torch.Tensor = struct.field()
    w0: torch.Tensor = struct.field()  # [..., 2m] delay-branch window
    w1: torch.Tensor = struct.field()  # [..., 2m] filter-branch window

    @classmethod
    def create(cls, m: int, f0: float = 0.0, as_: float = 60.0, batch_shape: tuple = (),
               dtype=torch.complex64, device=None) -> "Resamp2":
        """PM halfband design, optionally mixed to f0 (resamp2.rs:44-84)."""
        device = resolve_device(device)
        if m < 2:
            raise ConfigError("filter semi-length must be at least 2")
        if f0 < -0.5 or f0 > 0.5:
            raise ConfigError(f"f0 ({f0}) must be in [-0.5,0.5]")
        if as_ < 0.0:
            raise ConfigError(f"as ({as_}) must be greater than zero")
        h_len = 4 * m + 1
        hf = design.fir_design_pm_halfband_stopband_attenuation(m, as_)
        t = np.arange(h_len) - (h_len - 1) / 2.0
        if f0 == 0.0:
            h = 2.0 * hf * np.cos(2.0 * np.pi * t * f0)
            coeff_dtype = np.float32
        else:
            h = 2.0 * hf * np.exp(2j * np.pi * t * f0)
            coeff_dtype = np.complex64
        # h1[i] = h[h_len-2i-2] (resamp2.rs:64-68), dotprod oldest-first;
        # conv order: h1_conv[j] = h1[2m-1-j] = h[2j+1]
        h1_conv = np.asarray([h[2 * j + 1] for j in range(2 * m)], dtype=coeff_dtype)
        return cls(
            m=m,
            h1=torch.from_numpy(h1_conv).to(device),
            scale=torch.tensor(np.ones((), coeff_dtype), device=device),
            w0=torch.zeros(batch_shape + (2 * m,), dtype=dtype, device=device),
            w1=torch.zeros(batch_shape + (2 * m,), dtype=dtype, device=device),
        )

    # ------------------------------------------------------------- internals
    def _filter_branch(self, xs):
        """h1 over stream xs after the filter-branch window (only its last
        2m-1 samples are left context)."""
        xa = torch.cat([self.w1.to(xs.dtype), xs], dim=-1)
        return causal_conv_valid(xa[..., 1:], self.h1)

    def _delay_branch(self, xs):
        """Delay by m: y[n] = stream[n-m], the delay window first."""
        xa = torch.cat([self.w0.to(xs.dtype), xs], dim=-1)
        return xa[..., self.m : self.m + xs.shape[-1]]

    def _windows_at(self, xs0, xs1, n_valid):
        """Both branch windows after the first n_valid samples of xs0/xs1."""
        start = n_valid.clamp(0, xs0.shape[-1])  # as a dynamic slice clamps
        idx = start + torch.arange(2 * self.m, device=xs0.device)
        xa0 = torch.cat([self.w0.to(xs0.dtype), xs0], dim=-1)
        xa1 = torch.cat([self.w1.to(xs1.dtype), xs1], dim=-1)
        return xa0[..., idx], xa1[..., idx]

    def _masked(self, x, n_valid):
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(torch.arange(x.shape[-1], device=x.device) < n_valid, x, zero)

    # -------------------------------------------------- valid-prefix variants
    # Fixed-capacity buffers whose first n_valid samples are real: outputs are
    # computed over the whole buffer (the tail is zeros and the filters are
    # causal, so valid outputs are exact), masked beyond the valid count, and
    # the windows taken at the valid end. n_valid is a 0-d device tensor.

    def interp_execute_block_n(self, x, n_valid):
        """x [..., cap] with n_valid real samples → (y [..., 2·cap] zero
        beyond 2·n_valid, 2·n_valid, state)."""
        cap = x.shape[-1]
        x = self._masked(x, n_valid)
        y = torch.stack([self._delay_branch(x), self._filter_branch(x)], dim=-1)
        y = y.reshape(x.shape[:-1] + (2 * cap,)) * self.scale
        y = self._masked(y, 2 * n_valid)
        w0, w1 = self._windows_at(x, x, n_valid)
        return y, 2 * n_valid, self.replace(w0=w0, w1=w1)

    def decim_execute_block_n(self, x, n_valid):
        """x [..., cap] with n_valid (even) real samples → (y [..., cap/2]
        zero beyond n_valid/2, n_valid/2, state)."""
        cap = x.shape[-1]
        if cap % 2:
            raise ConfigError("decimator buffer capacity must be even")
        x = self._masked(x, n_valid)
        xe = x[..., 0::2]
        xo = x[..., 1::2]
        nh = n_valid // 2
        y = (self._delay_branch(xo) + self._filter_branch(xe)) * self.scale
        y = self._masked(y, nh)
        w0, w1 = self._windows_at(xo, xe, nh)
        return y, nh, self.replace(w0=w0, w1=w1)
