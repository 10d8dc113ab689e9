"""Halfband 2× interpolator/decimator and analysis/synthesis QMF pair.

Port of :mod:`yagi_tpu.filter.resamp2` (reference: resamp2.rs). The PM
halfband prototype (4m+1 taps, even outer taps zero) splits into a pure delay
branch (the center tap) and an odd-tap filter branch h1 (resamp2.rs:44-84);
each mode routes even and odd samples through the two branches (decim
resamp2.rs:153, interp :165, analyzer :126, synthesizer :139, filter :104).
State: the two 2m-sample branch windows. The valid-prefix forms
(``*_execute_block_n``) chain :class:`~yagi_tpu_torch.filter.MsResamp2`'s
stages on a fixed-capacity buffer with a count on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
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

    def reset(self) -> "Resamp2":
        return self.replace(w0=torch.zeros_like(self.w0), w1=torch.zeros_like(self.w1))

    def set_scale(self, scale) -> "Resamp2":
        return self.replace(
            scale=torch.tensor(scale, dtype=self.scale.dtype, device=self.scale.device))

    def get_scale(self):
        return self.scale

    def get_delay(self) -> int:
        """2m-1 samples at the high rate (resamp2.rs:100)."""
        return 2 * self.m - 1

    # ------------------------------------------------------------- internals
    def _filter_branch(self, w, xs):
        """h1 over stream xs after the window w (only its last 2m-1 samples
        are left context: output t uses the window after pushing xs[t]);
        and the window after xs."""
        xa = torch.cat([w.to(xs.dtype), xs], dim=-1)
        return causal_conv_valid(xa[..., 1:], self.h1), carry(w, xa)

    def _delay_branch(self, w, xs):
        """Delay by m: y[n] = stream[n-m], the window first; and the window
        after xs."""
        xa = torch.cat([w.to(xs.dtype), xs], dim=-1)
        return xa[..., self.m : self.m + xs.shape[-1]], carry(w, xa)

    # ----------------------------------------------------------------- modes
    def decim_execute_block(self, x) -> tuple[torch.Tensor, "Resamp2"]:
        """2N inputs → N outputs (resamp2.rs:153): even → h1, odd → delay."""
        x = torch.as_tensor(x, device=self.h1.device)
        if x.shape[-1] % 2:
            raise ConfigError("decimator input length must be even")
        y1, w1 = self._filter_branch(self.w1, x[..., 0::2])
        y0, w0 = self._delay_branch(self.w0, x[..., 1::2])
        return (y0 + y1) * self.scale, self.replace(w0=w0, w1=w1)

    def interp_execute_block(self, x) -> tuple[torch.Tensor, "Resamp2"]:
        """N inputs → 2N outputs (resamp2.rs:165): y[2n] = delay, y[2n+1] = h1."""
        x = torch.as_tensor(x, device=self.h1.device)
        y0, w0 = self._delay_branch(self.w0, x)
        y1, w1 = self._filter_branch(self.w1, x)
        y = torch.stack([y0, y1], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))
        return y * self.scale, self.replace(w0=w0, w1=w1)

    def analyzer_execute_block(self, x) -> tuple[torch.Tensor, torch.Tensor, "Resamp2"]:
        """2N inputs → (low[N], high[N]) (resamp2.rs:126-137)."""
        x = torch.as_tensor(x, device=self.h1.device)
        if x.shape[-1] % 2:
            raise ConfigError("analyzer input length must be even")
        y1, w1 = self._filter_branch(self.w1, 0.5 * x[..., 0::2])
        y0, w0 = self._delay_branch(self.w0, 0.5 * x[..., 1::2])
        return (y1 + y0) * self.scale, (y1 - y0) * self.scale, self.replace(w0=w0, w1=w1)

    def synthesizer_execute_block(self, x0, x1) -> tuple[torch.Tensor, "Resamp2"]:
        """(low[N], high[N]) → 2N outputs (resamp2.rs:139-151)."""
        x0 = torch.as_tensor(x0, device=self.h1.device)
        x1 = torch.as_tensor(x1, device=self.h1.device)
        y0, w0 = self._delay_branch(self.w0, x0 + x1)
        y1, w1 = self._filter_branch(self.w1, x0 - x1)
        y = torch.stack([y0 * self.scale, y1 * self.scale], dim=-1)
        return y.reshape(x0.shape[:-1] + (2 * x0.shape[-1],)), self.replace(w0=w0, w1=w1)

    def filter_execute_block(self, x) -> tuple[torch.Tensor, torch.Tensor, "Resamp2"]:
        """Per-sample lowpass/highpass pair (resamp2.rs:104-124).

        Sample n goes to window n % 2; output yi is that window's delayed
        sample, yq is h1 over the OTHER window. The block length must be even,
        so the sample-parity phase starts at 0 in every block.
        """
        x = torch.as_tensor(x, device=self.h1.device)
        n = x.shape[-1]
        if n % 2:
            raise ConfigError("filter_execute block length must be even (toggle phase)")
        xe = x[..., 0::2]  # → w0
        xo = x[..., 1::2]  # → w1
        # even step (push xe[i]): yi = w0 delayed, yq = h1 over w1 before
        # xo[i] is pushed; odd step (push xo[i]): yi = w1 delayed, yq = h1
        # over w0 after xe[i] is pushed
        y0_even, w0 = self._delay_branch(self.w0, xe)
        y0_odd, w1 = self._delay_branch(self.w1, xo)
        xa1 = torch.cat([self.w1.to(x.dtype), xo[..., :-1]], dim=-1)
        yq_even = causal_conv_valid(xa1, self.h1)[..., : xe.shape[-1]]
        yq_odd, _ = self._filter_branch(self.w0, xe)
        yi = torch.stack([y0_even, y0_odd], dim=-1).reshape(x.shape)
        yq = torch.stack([yq_even, yq_odd], dim=-1).reshape(x.shape)
        half = torch.tensor(0.5, dtype=self.scale.dtype, device=self.scale.device)
        return (half * (yi + yq) * self.scale, half * (yi - yq) * self.scale,
                self.replace(w0=w0, w1=w1))

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
        y = torch.stack([self._delay_branch(self.w0, x)[0], self._filter_branch(self.w1, x)[0]],
                        dim=-1)
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
        y = (self._delay_branch(self.w0, xo)[0] + self._filter_branch(self.w1, xe)[0]) * self.scale
        y = self._masked(y, nh)
        w0, w1 = self._windows_at(xo, xe, nh)
        return y, nh, self.replace(w0=w0, w1=w1)
