"""Fused M = 64 channelizer: one kernel per block (planar I/O).

Port of :mod:`yagi_tpu.multichannel.fused`. Same DSP as :class:`Firpfbch`
analysis (liquid firpfbch algorithm) for the M = 64 config[4] workload,
run as one kernel that reads the input once (kernels/channelizer.py). State
is the raw trailing input samples; output is step-major [T, 64] planar
(transpose for the channel-major view :class:`Firpfbch` returns).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ..filter.firpfb import pfb_decompose
from ..kernels.channelizer import channelizer_tables, fused_channelizer_apply, halo_rows
from .firpfbch import _design_prototype

__all__ = ["FusedChannelizer"]

# Every mode runs the fp32 kernel (fp32 FMA sums). On the TPU they chose the
# MXU pass count of the IDFT dot (lax.Precision HIGHEST or DEFAULT).
_PRECISIONS = ("highest", "default")


@struct.state
class FusedChannelizer:
    """Fused M=64 polyphase analysis bank state."""

    p: int = struct.static_field()  # taps per branch
    # rows of 128 samples per tile: a Mosaic tiling hint on the TPU, kept with
    # its block-length rule (N a multiple of 128·r2) so the state and the
    # accepted blocks match yagi_tpu's. The CUDA kernel's tiles do not use it.
    r2: int = struct.static_field()
    precision: str = struct.static_field()
    taps: torch.Tensor = struct.field()  # [p, 128]
    hr: torch.Tensor = struct.field()  # [128, 128] blockdiag IDFT (re)
    hi: torch.Tensor = struct.field()  # [128, 128] blockdiag IDFT (im)
    hist_r: torch.Tensor = struct.field()  # [halo·128] raw input history
    hist_i: torch.Tensor = struct.field()

    num_channels = 64

    @classmethod
    def create_kaiser(
        cls, num_channels: int = 64, m: int = 4, as_: float = 60.0,
        scale: float = 1.0, r2: int = 128, precision: str = "highest", device=None,
    ) -> "FusedChannelizer":
        device = resolve_device(device)
        if num_channels != 64:
            raise ConfigError("FusedChannelizer is specialized to 64 channels")
        if m < 1:
            raise ConfigError("filter semi-length must be at least 1")
        if precision not in _PRECISIONS:
            raise ConfigError(f"precision must be one of {_PRECISIONS}")
        h = _design_prototype(num_channels, m, as_)
        branches = pfb_decompose(np.asarray(h), num_channels)
        p = branches.shape[1]
        taps, hr, hi = channelizer_tables(branches, scale)
        nh = halo_rows(p) * 128
        return cls(
            p=p,
            r2=r2,
            precision=precision,
            taps=torch.from_numpy(taps).to(device),
            hr=torch.from_numpy(hr).to(device),
            hi=torch.from_numpy(hi).to(device),
            hist_r=torch.zeros(nh, dtype=torch.float32, device=device),
            hist_i=torch.zeros(nh, dtype=torch.float32, device=device),
        )

    def analyzer_execute_planar(self, xr, xi):
        """Planar stream planes [N] → (yr, yi [T, 64] step-major, state)."""
        yr, yi = fused_channelizer_apply(
            xr, xi, self.taps, self.hr, self.hi, self.hist_r, self.hist_i,
            p=self.p, r2=self.r2,
        )
        nh = self.hist_r.shape[-1]
        # copies, so the state does not alias the caller's buffers
        new = self.replace(hist_r=xr[-nh:].clone(), hist_i=xi[-nh:].clone())
        return yr, yi, new

    def analyzer_execute(self, x):
        """Complex convenience: [N] → ([64, T] channel-major, state), the
        layout of :meth:`Firpfbch.analyzer_execute`."""
        x = torch.as_tensor(x, dtype=torch.complex64, device=self.taps.device)
        yr, yi, new = self.analyzer_execute_planar(x.real.contiguous(), x.imag.contiguous())
        return torch.complex(yr, yi).T, new
