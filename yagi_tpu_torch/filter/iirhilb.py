"""IIR-based Hilbert transform, decimator, interpolator.

Port of :mod:`yagi_tpu.filter.iirhilb`:
* IirHilbertFilter — iirhilb.rs: two real IIR
  lowpass prototypes fed with a 4-phase (r2c/c2r) or 2-phase (decim/interp)
  commutation of ±re/±im samples. The commutation is a deterministic cyclic
  pattern, so block forms precompute the sign/selection sequences and run the
  two IIR scans once over the whole block.
* IirDecimationFilter — iirdecim.rs: anti-alias IIR + keep every M-th.
* IirInterpolationFilter — iirinterp.rs: zero-stuff + anti-image IIR ×M.
"""

from __future__ import annotations

import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ..design import iir as iirdes
from .iirfilt import IirFilter

__all__ = ["IirHilbertFilter", "IirDecimationFilter", "IirInterpolationFilter"]


@struct.state
class IirHilbertFilter:
    """Hilbert state (iirhilb.rs:7-12)."""

    filt0: IirFilter = struct.field()
    filt1: IirFilter = struct.field()
    state: torch.Tensor = struct.field()  # int32 phase (0..3 r2c/c2r, 0..1 decim/interp)

    @classmethod
    def create(
        cls,
        ftype=iirdes.IirFilterShape.BUTTER,
        n: int = 5,
        ap: float = 0.1,
        as_: float = 60.0,
        batch_shape: tuple = (),
        device=None,
    ) -> "IirHilbertFilter":
        device = resolve_device(device)
        if n == 0:
            raise ConfigError("filter order must be greater than zero")
        mk = lambda: IirFilter.create_prototype(  # noqa: E731
            ftype,
            iirdes.IirBandType.LOWPASS,
            iirdes.IirFormat.SECOND_ORDER_SECTIONS,
            n,
            0.25,
            0.0,
            ap,
            as_,
            batch_shape=batch_shape,
            dtype=torch.float32,
            device=device,
        )
        return cls(filt0=mk(), filt1=mk(),
                   state=torch.tensor(0, dtype=torch.int32, device=device))

    @classmethod
    def create_default(cls, n: int, **kw) -> "IirHilbertFilter":
        return cls.create(iirdes.IirFilterShape.BUTTER, n, 0.1, 60.0, **kw)

    def reset(self) -> "IirHilbertFilter":
        return self.replace(
            filt0=self.filt0.reset(),
            filt1=self.filt1.reset(),
            state=torch.zeros_like(self.state),
        )

    def parallelize(self) -> "IirHilbertFilter":
        """Run both halfband IIRs via the log-depth parallel recurrence."""
        return self.replace(
            filt0=self.filt0.parallelize(), filt1=self.filt1.parallelize()
        )

    def decim_execute_block(self, x) -> tuple[torch.Tensor, "IirHilbertFilter"]:
        """Real [..., 2N] → complex [..., N] (iirhilb.rs:126-147).

        Per pair (state s): filt0 sees [±x0, 0], filt1 sees [0, ∓x1]; the
        output is 2·(filt0_first, filt1_first); s alternates per pair.
        """
        x = torch.as_tensor(x, dtype=torch.float32, device=self.state.device)
        if x.shape[-1] % 2:
            raise ConfigError("decimator input length must be even")
        n = x.shape[-1] // 2
        x0 = x[..., 0::2]
        x1 = x[..., 1::2]
        s = (torch.arange(n, device=x.device) + self.state) % 2  # 0: (x, -x1); 1: (-x, x1)
        sign = torch.where(s == 0, 1.0, -1.0)
        xi = x0 * sign
        xq = -x1 * sign
        # filt0 input stream: [xi0, 0, xi1, 0, ...]; filt1: [0, xq0, 0, xq1, ...]
        f0_in = torch.stack([xi, torch.zeros_like(xi)], dim=-1).reshape(x.shape)
        f1_in = torch.stack([torch.zeros_like(xq), xq], dim=-1).reshape(x.shape)
        y0, filt0 = self.filt0.execute_block(f0_in)
        y1, filt1 = self.filt1.execute_block(f1_in)
        yi = y0[..., 0::2]
        yq = y1[..., 0::2]
        y = 2.0 * torch.complex(yi, yq)
        new_state = (self.state + n) % 2
        return y.to(torch.complex64), self.replace(
            filt0=filt0, filt1=filt1, state=new_state
        )

    def interp_execute_block(self, x) -> tuple[torch.Tensor, "IirHilbertFilter"]:
        """Complex [..., N] → real [..., 2N] (iirhilb.rs:152-166)."""
        x = torch.as_tensor(x, device=self.state.device)
        n = x.shape[-1]
        xr = x.real if x.is_complex() else x
        xq = x.imag if x.is_complex() else torch.zeros_like(x)
        f0_in = torch.stack([xr, torch.zeros_like(xr)], dim=-1).reshape(
            x.shape[:-1] + (2 * n,)
        ).to(torch.float32)
        f1_in = torch.stack([xq, torch.zeros_like(xq)], dim=-1).reshape(
            x.shape[:-1] + (2 * n,)
        ).to(torch.float32)
        y0, filt0 = self.filt0.execute_block(f0_in)
        y1, filt1 = self.filt1.execute_block(f1_in)
        yi0 = y0[..., 0::2]
        yq1 = y1[..., 1::2]
        s = (torch.arange(n, device=x.device) + self.state) % 2
        sign = torch.where(s == 0, 1.0, -1.0)
        out0 = 2.0 * yi0 * sign
        out1 = -2.0 * yq1 * sign
        y = torch.stack([out0, out1], dim=-1).reshape(x.shape[:-1] + (2 * n,))
        new_state = (self.state + n) % 2
        return y, self.replace(filt0=filt0, filt1=filt1, state=new_state)


@struct.state
class IirDecimationFilter:
    """IIR anti-alias + M:1 keep (iirdecim.rs)."""

    decim: int = struct.static_field()
    iirfilt: IirFilter = struct.field()

    @classmethod
    def create(cls, decim: int, b, a, **kw) -> "IirDecimationFilter":
        if decim < 2:
            raise ConfigError("decimation factor must be greater than 1")
        return cls(decim=decim, iirfilt=IirFilter.create(b, a, **kw))

    @classmethod
    def create_default(cls, decim: int, order: int, **kw) -> "IirDecimationFilter":
        return cls.create_prototype(
            decim,
            iirdes.IirFilterShape.BUTTER,
            iirdes.IirBandType.LOWPASS,
            iirdes.IirFormat.SECOND_ORDER_SECTIONS,
            order,
            0.5 / decim,
            0.0,
            0.1,
            60.0,
            **kw,
        )

    @classmethod
    def create_prototype(cls, decim: int, ftype, btype, fmt, order, fc, f0, ap, as_, **kw):
        if decim < 2:
            raise ConfigError("decimation factor must be greater than 1")
        filt = IirFilter.create_prototype(ftype, btype, fmt, order, fc, f0, ap, as_, **kw)
        return cls(decim=decim, iirfilt=filt)

    def reset(self):
        return self.replace(iirfilt=self.iirfilt.reset())

    def parallelize(self):
        """Log-depth parallel recurrence for the anti-alias IIR."""
        return self.replace(iirfilt=self.iirfilt.parallelize())

    def execute_block(self, x) -> tuple[torch.Tensor, "IirDecimationFilter"]:
        """Filter all samples, keep the FIRST of each group (iirdecim.rs
        execute computes output at the first push of each group)."""
        x = torch.as_tensor(x, device=self.iirfilt.v.device)
        if x.shape[-1] % self.decim:
            raise ConfigError("input length must be a multiple of the decimation factor")
        y_full, filt = self.iirfilt.execute_block(x)
        return y_full[..., :: self.decim], self.replace(iirfilt=filt)

    __call__ = execute_block


@struct.state
class IirInterpolationFilter:
    """Zero-stuff + IIR anti-image (iirinterp.rs)."""

    interp: int = struct.static_field()
    iirfilt: IirFilter = struct.field()

    @classmethod
    def create(cls, m: int, b, a, **kw) -> "IirInterpolationFilter":
        if m < 2:
            raise ConfigError("interp factor must be greater than 1")
        return cls(interp=m, iirfilt=IirFilter.create(b, a, **kw))

    @classmethod
    def create_default(cls, m: int, order: int, **kw) -> "IirInterpolationFilter":
        return cls.create_prototype(
            m,
            iirdes.IirFilterShape.CHEBY2,
            iirdes.IirBandType.LOWPASS,
            iirdes.IirFormat.SECOND_ORDER_SECTIONS,
            order,
            0.5 / m,
            0.0,
            0.1,
            60.0,
            **kw,
        )

    @classmethod
    def create_prototype(cls, m: int, ftype, btype, fmt, order, fc, f0, ap, as_, **kw):
        if m < 2:
            raise ConfigError("interp factor must be greater than 1")
        filt = IirFilter.create_prototype(ftype, btype, fmt, order, fc, f0, ap, as_, **kw)
        filt = filt.set_scale(float(m))
        return cls(interp=m, iirfilt=filt)

    def reset(self):
        return self.replace(iirfilt=self.iirfilt.reset())

    def parallelize(self):
        """Log-depth parallel recurrence for the image-rejection IIR."""
        return self.replace(iirfilt=self.iirfilt.parallelize())

    def execute_block(self, x) -> tuple[torch.Tensor, "IirInterpolationFilter"]:
        """Zero-stuff each input then filter (iirinterp.rs execute)."""
        x = torch.as_tensor(x, device=self.iirfilt.v.device)
        n = x.shape[-1]
        up = torch.zeros(x.shape[:-1] + (n, self.interp), dtype=x.dtype, device=x.device)
        up[..., 0] = x
        up = up.reshape(x.shape[:-1] + (n * self.interp,))
        y, filt = self.iirfilt.execute_block(up)
        return y, self.replace(iirfilt=filt)

    __call__ = execute_block
