"""Fractional delay, order-statistic filter, LPC.

Port of :mod:`yagi_tpu.filter.misc`:

* Fdelay (reference: fdelay.rs): the integer part of the delay is a tap of a
  length nmax+1 window, the fractional part a PFB branch;
* OrdFilt (ordfilt.rs): the k-th order statistic of a sliding window (the
  median as a special case); a block sorts all its windows at once;
* design_lpc / levinson (lpc.rs): autocorrelation method and the
  Levinson-Durbin recursion, host-side float64 NumPy, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from ._conv import causal_conv_valid
from .firpfb import FirPfbFilter

__all__ = ["Fdelay", "OrdFilt", "design_lpc", "levinson"]


@struct.state
class Fdelay:
    """Adjustable fractional delay (fdelay.rs:8-18)."""

    nmax: int = struct.static_field()
    m: int = struct.static_field()
    npfb: int = struct.static_field()
    delay: torch.Tensor = struct.field()  # float32
    w: torch.Tensor = struct.field()  # [..., nmax+1] window oldest..newest
    pfb: FirPfbFilter = struct.field()
    w_index: torch.Tensor = struct.field()  # int32 integer-delay tap
    f_index: torch.Tensor = struct.field()  # int32 PFB branch

    @classmethod
    def create(cls, nmax: int, m: int = 8, npfb: int = 64, batch_shape: tuple = (),
               dtype=torch.complex64, device=None) -> "Fdelay":
        device = resolve_device(device)
        if nmax == 0:
            raise ConfigError("maximum delay must be greater than zero")
        if m == 0:
            raise ConfigError("filter semi-length must be greater than zero")
        if npfb == 0:
            raise ConfigError("number of filters must be greater than zero")
        pfb = FirPfbFilter.create_default(npfb, m, batch_shape=batch_shape, dtype=dtype,
                                          device=device)
        return cls(
            nmax=nmax,
            m=m,
            npfb=npfb,
            delay=torch.tensor(0.0, dtype=torch.float32, device=device),
            w=torch.zeros(batch_shape + (nmax + 1,), dtype=dtype, device=device),
            pfb=pfb,
            w_index=torch.tensor(nmax - 1, dtype=torch.int32, device=device),
            f_index=torch.tensor(0, dtype=torch.int32, device=device),
        )

    def reset(self) -> "Fdelay":
        return self.replace(
            delay=torch.zeros_like(self.delay),
            w=torch.zeros_like(self.w),
            pfb=self.pfb.reset(),
            w_index=torch.full_like(self.w_index, self.nmax - 1),
            f_index=torch.zeros_like(self.f_index),
        )

    def get_delay(self):
        return self.delay

    def set_delay(self, delay) -> "Fdelay":
        """Split into an integer window tap and a fractional PFB branch
        (fdelay.rs:72-98), in float32 as the reference."""
        d_val = float(delay)
        if d_val < 0.0:
            raise ConfigError("delay cannot be negative")
        if d_val > self.nmax:
            raise ConfigError(f"delay ({d_val}) cannot exceed maximum ({self.nmax})")
        d = torch.as_tensor(delay, dtype=torch.float32, device=self.delay.device)
        offset = self.nmax - d
        intpart = torch.floor(offset).to(torch.int32)
        fracpart = offset - intpart.to(torch.float32)
        f_index = torch.round(self.npfb * fracpart).to(torch.int32)
        carry_ = torch.div(f_index, self.npfb, rounding_mode="floor")
        return self.replace(
            delay=d,
            w_index=intpart + carry_,
            f_index=f_index - carry_ * self.npfb,
        )

    def adjust_delay(self, delta) -> "Fdelay":
        return self.set_delay(self.delay + delta)

    def execute_block(self, x) -> tuple[torch.Tensor, "Fdelay"]:
        """Delay a block (fdelay.rs:117-135): per sample, the window's
        w_index-th tap feeds the PFB's f_index branch."""
        x = torch.as_tensor(x, device=self.w.device)
        n = x.shape[-1]
        xa = torch.cat([self.w.to(x.dtype), x], dim=-1)
        # after pushing x[i], tap w_index of the window (length nmax+1) is
        # xa[i + 1 + w_index]
        tapped = xa[..., torch.arange(n, device=x.device) + 1 + self.w_index]
        hb = self.pfb.branches.index_select(0, self.f_index.reshape(1))[0]
        pa = torch.cat([self.pfb.window[..., 1:].to(x.dtype), tapped], dim=-1)
        y = causal_conv_valid(pa, hb) * self.pfb.scale
        new_pfb = self.pfb.replace(window=carry(self.pfb.window, pa))
        return y, self.replace(w=carry(self.w, xa), pfb=new_pfb)

    __call__ = execute_block


@struct.state
class OrdFilt:
    """Order-statistic filter (ordfilt.rs:5-10)."""

    n: int = struct.static_field()
    k: int = struct.static_field()
    buf: torch.Tensor = struct.field()  # [..., n-1] history

    @classmethod
    def create(cls, n: int, k: int, batch_shape: tuple = (), dtype=torch.float32,
               device=None) -> "OrdFilt":
        device = resolve_device(device)
        if n == 0:
            raise ConfigError("filter length must be greater than zero")
        if k >= n:
            raise ConfigError("filter index must be in [0,n-1]")
        return cls(n=n, k=k, buf=torch.zeros(batch_shape + (n - 1,), dtype=dtype, device=device))

    @classmethod
    def create_medfilt(cls, m: int, **kw) -> "OrdFilt":
        """Median filter of length 2m+1 (ordfilt.rs:32)."""
        return cls.create(2 * m + 1, m, **kw)

    def reset(self) -> "OrdFilt":
        return self.replace(buf=torch.zeros_like(self.buf))

    def execute_block(self, x) -> tuple[torch.Tensor, "OrdFilt"]:
        """y[t] = k-th smallest of the window ending at x[t] (ordfilt.rs:48)."""
        x = torch.as_tensor(x, device=self.buf.device)
        if x.shape[-1] == 0:  # an empty block: no outputs, the history stands
            return x.clone(), self
        xa = torch.cat([self.buf.to(x.dtype), x], dim=-1)
        frames = xa.unfold(-1, self.n, 1)  # [..., nt, n], a view
        if frames.is_complex():
            # jnp.sort's order: by real part, then by imaginary part. A stable
            # sort on the imaginary part, then a stable one on the real part
            order = torch.sort(frames.imag, dim=-1, stable=True).indices
            frames = frames.gather(-1, order)
            order = torch.sort(frames.real, dim=-1, stable=True).indices
            y = frames.gather(-1, order[..., self.k : self.k + 1])[..., 0]
        else:
            y = torch.sort(frames, dim=-1).values[..., self.k]
        return y, self.replace(buf=carry(self.buf, xa))

    __call__ = execute_block


def design_lpc(x, p: int):
    """Linear prediction coefficients via the autocorrelation method
    (lpc.rs:14). Returns (a [p+1], g [p+1]) with a[0] = 1."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if p > n:
        raise ConfigError("prediction filter length cannot exceed input signal length")
    r = np.array([np.sum(x[lag:] * x[: n - lag]) for lag in range(p + 1)])
    return levinson(r, p)


def levinson(r, p: int):
    """Levinson-Durbin recursion (lpc.rs:48-89)."""
    if p > 256:
        raise ConfigError(f"filter order ({p}) exceeds maximum (256)")
    r = np.asarray(r, dtype=np.float64)
    a0 = np.zeros(p + 1)
    a1 = np.zeros(p + 1)
    e = np.zeros(p + 1)
    k = np.zeros(p + 1)
    k[0] = 1.0
    e[0] = r[0]
    a0[0] = a1[0] = 1.0
    for n in range(1, p + 1):
        q = np.sum(a0[:n] * r[n:0:-1])
        k[n] = -q / e[n - 1]
        e[n] = e[n - 1] * (1.0 - k[n] * k[n])
        for i in range(n):
            a1[i] = a0[i] + k[n] * a0[n - i]
        a1[n] = k[n]
        a0[: p + 1] = a1
    return a1.astype(np.float32), e.astype(np.float32)
