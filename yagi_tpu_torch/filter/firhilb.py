"""FIR Hilbert transform: real↔complex 2:1 converters.

Port of :mod:`yagi_tpu.filter.firhilb` (firhilb.rs). The quadrature
branch filter hq is derived from a kaiser halfband at fc=0.25 with
alternating-sign rotation (firhilb.rs:43-64); decim (r2c) routes even real
samples through hq and odd through a delay, with a per-pair sign toggle
(firhilb.rs:190-211); interp (c2r) is the adjoint (firhilb.rs:233-247).
Block forms vectorize with stride-2 splits and one convolution.
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

__all__ = ["FirHilbertFilter"]


@struct.state
class FirHilbertFilter:
    """Hilbert transform state (firhilb.rs:15-24)."""

    m: int = struct.static_field()
    hq: torch.Tensor = struct.field()  # [2m] quadrature taps, conv order
    w0: torch.Tensor = struct.field()  # [..., 2m] delay branch
    w1: torch.Tensor = struct.field()  # [..., 2m] filter branch
    toggle: torch.Tensor = struct.field()  # bool — pair sign state

    @classmethod
    def create(cls, m: int, as_: float = 60.0, batch_shape: tuple = (),
               device=None) -> "FirHilbertFilter":
        device = resolve_device(device)
        if m < 2:
            raise ConfigError("filter semi-length (m) must be at least 2")
        h_len = 4 * m + 1
        as_ = abs(as_)
        h = design.fir_design_kaiser(h_len, 0.25, as_, 0.0)
        t = np.arange(h_len) - (h_len - 1) / 2.0
        h_rot = h * np.exp(0.5j * np.pi * t)
        him = h_rot.imag
        # hq[j] = him[h_len - (2j+1) - 1], dotprod oldest-first (firhilb.rs:60-64)
        hq = np.array([him[h_len - (2 * j + 1) - 1] for j in range(2 * m)])
        # conv order (newest-first): hq_conv[i] = hq[2m-1-i]
        hq_conv = hq[::-1].astype(np.float32)
        return cls(
            m=m,
            hq=torch.from_numpy(hq_conv).to(device),
            w0=torch.zeros(tuple(batch_shape) + (2 * m,), dtype=torch.float32, device=device),
            w1=torch.zeros(tuple(batch_shape) + (2 * m,), dtype=torch.float32, device=device),
            toggle=torch.tensor(False, device=device),
        )

    def reset(self) -> "FirHilbertFilter":
        return self.replace(
            w0=torch.zeros_like(self.w0),
            w1=torch.zeros_like(self.w1),
            toggle=torch.zeros_like(self.toggle),
        )

    def _sign(self, n: int) -> torch.Tensor:
        """(−1)^i for pair i, continuing the carried toggle."""
        i = torch.arange(n, device=self.hq.device) + self.toggle.to(torch.int64)
        return torch.where(i % 2 == 0, 1.0, -1.0)

    def _conv_branch(self, w, xs):
        # window holds 2m samples; conv left-context is the last 2m-1
        xa = torch.cat([w, xs], dim=-1)
        y = causal_conv_valid(xa[..., 1:], self.hq)
        return y, carry(w, xa)

    def _delay_branch(self, w, xs):
        xa = torch.cat([w, xs], dim=-1)
        n = xs.shape[-1]
        y = xa[..., self.m : self.m + n]
        return y, carry(w, xa)

    def decim_execute_block(self, x) -> tuple[torch.Tensor, "FirHilbertFilter"]:
        """Real [..., 2N] → complex [..., N] (firhilb.rs:190-226).

        Pair i: yq from even sample through hq, yi from odd sample delayed m;
        output (yi + j·yq)·(-1)^i continuing the carried toggle.
        """
        x = torch.as_tensor(x, dtype=torch.float32, device=self.hq.device)
        if x.shape[-1] % 2:
            raise ConfigError("decimator input length must be even")
        xe = x[..., 0::2]
        xo = x[..., 1::2]
        yq, w1 = self._conv_branch(self.w1, xe)
        yi, w0 = self._delay_branch(self.w0, xo)
        n = xe.shape[-1]
        sign = self._sign(n)
        y = torch.complex(yi * sign, yq * sign)
        new_toggle = torch.logical_xor(self.toggle, torch.tensor(n % 2 == 1, device=x.device))
        return y, self.replace(
            w0=w0, w1=w1, toggle=new_toggle
        )

    def interp_execute_block(self, x) -> tuple[torch.Tensor, "FirHilbertFilter"]:
        """Complex [..., N] → real [..., 2N] (firhilb.rs:233-247)."""
        x = torch.as_tensor(x, device=self.hq.device)
        n = x.shape[-1]
        sign = self._sign(n)
        vi = (x.real * sign).to(torch.float32)
        vq = (x.imag * sign).to(torch.float32)
        y0, w0 = self._delay_branch(self.w0, vq)
        y1, w1 = self._conv_branch(self.w1, vi)
        y = torch.stack([y0, y1], dim=-1).reshape(x.shape[:-1] + (2 * n,))
        new_toggle = torch.logical_xor(self.toggle, torch.tensor(n % 2 == 1, device=x.device))
        return y, self.replace(w0=w0, w1=w1, toggle=new_toggle)

    def get_delay(self) -> int:
        return 2 * self.m + 1
