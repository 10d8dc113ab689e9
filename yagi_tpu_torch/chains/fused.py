"""Fused receive chain: one kernel per block (planar or complex I/O).

Port of :mod:`yagi_tpu.chains.fused`. Same DSP as :class:`RxChain` — 64-tap
Kaiser FIR lowpass → P× polyphase interpolating resampler (u32 phase,
resamp.rs:141-154) → NCO mix-down (osc.rs:179) — specialized to integer
rates so the whole chain runs as one kernel (kernels/chain.py).

State is 128 samples of raw input history (from which both the FIR window,
firfilt.rs:220, and the resampler's PFB window are implied) plus the u32 NCO
phase. The resampler phase is identically 0 at every block edge because
step·P = 2^24 exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolves_device
from .._src.struct import U32
from .. import design, trace
from ..errors import ConfigError
from ..filter.firpfb import pfb_decompose
from ..kernels.chain import (chain_matrices, compact_taps, fused_chain_apply,
                             fused_chain_apply_c64)
from ..nco import Osc

__all__ = ["FusedRxChain"]

# Every mode runs the fp32 kernel (fp32 FMA sums), which is inside each
# mode's documented tolerance. On the TPU they chose the MXU pass count:
# "highest"/"high"/"default" are lax.Precision levels and "bf16x3" is a
# 3-pass bf16 split at ~2^-21 relative error (yagi_tpu/kernels/chain.py).
_PRECISIONS = ("highest", "high", "default", "bf16x3")


@struct.state
class FusedRxChain:
    """Fused firfilt→resamp(P×)→mix_down chain state."""

    p: int = struct.static_field()  # integer interpolation rate
    # rows of 128 samples per tile: a Mosaic tiling hint on the TPU. It means
    # nothing to the CUDA kernel and is kept so the state matches field for
    # field.
    r: int = struct.static_field()
    precision: str = struct.static_field()
    g: torch.Tensor = struct.field()  # [2, 128, 128·P] banded chain matrices
    hist_r: torch.Tensor = struct.field()  # [C, 128] input history planes
    hist_i: torch.Tensor = struct.field()
    theta: torch.Tensor = struct.field()  # u32 NCO phase, int64
    d_theta: torch.Tensor = struct.field()  # u32 NCO frequency, int64
    # [P, Kp] compact combined filters, the form the CUDA kernel reads: derived
    # from g wherever the state is built without them (create, load_state)
    taps: torch.Tensor = struct.field(default=None)

    def __post_init__(self):
        if self.taps is None:
            with trace.span("yagi.rxchain.taps", always=True):
                taps = torch.from_numpy(compact_taps(self.g, self.p)).to(self.g.device)
            object.__setattr__(self, "taps", taps)

    @classmethod
    @resolves_device
    @trace.spanned("yagi.rxchain.create", always=True)
    def create(
        cls,
        n_taps: int = 64,
        fc: float = 0.2,
        as_: float = 60.0,
        rate: float = 2.0,
        mix_freq: float = 0.35,
        m: int = 7,
        npfb: int = 256,
        batch_shape: tuple = (),
        r: int = 16,
        precision: str = "highest",
        device=None,
    ) -> "FusedRxChain":
        p = int(round(rate))
        if p != rate or p < 1:
            raise ConfigError("FusedRxChain requires an integer rate")
        if npfb % p or (1 << 24) % p:
            raise ConfigError("rate must divide npfb and 2^24")
        if precision not in _PRECISIONS:
            raise ConfigError(f"precision must be one of {_PRECISIONS}")
        h_fir, branches = cls.design_filters(n_taps, fc, as_, m, npfb)
        g = chain_matrices(h_fir, 2.0 * fc, branches, p)
        if len(batch_shape) != 1:
            raise ConfigError("FusedRxChain takes batch_shape=(channels,)")
        c = batch_shape[0]
        osc = Osc.create("exact", device=device).set_frequency(mix_freq)
        return cls(
            p=p,
            r=r,
            precision=precision,
            g=torch.from_numpy(g).to(device),
            hist_r=torch.zeros((c, 128), dtype=torch.float32, device=device),
            hist_i=torch.zeros((c, 128), dtype=torch.float32, device=device),
            theta=osc.theta,
            d_theta=osc.d_theta,
        )

    @staticmethod
    def design_filters(n_taps: int, fc: float, as_: float, m: int, npfb: int):
        """The chain's filters, reference-parity designs in host-side numpy:
        the Kaiser FIR taps (their output scale is 2·fc) and the resampler's
        polyphase branches [npfb, 2m] in convolution order."""
        h_fir = design.fir_design_kaiser(n_taps, fc, as_, 0.0)
        n = 2 * m * npfb + 1
        hf = design.fir_design_kaiser(n, 0.25 / npfb, as_, 0.0)
        h_pfb = (hf * (npfb / np.sum(hf))).astype(np.float32)
        return h_fir, pfb_decompose(h_pfb[: n - 1], npfb)

    # ------------------------------------------------------------- streaming
    @trace.spanned("yagi.rxchain.step", first="yagi.rxchain.first_step")
    def step_planar(self, xr, xi):
        """Planar block step: returns (yr, yi, num_valid, new_chain).

        xr/xi: [C, T] float32, T a multiple of 128. num_valid = T·P.
        """
        yr, yi = fused_chain_apply(
            xr, xi, self.g, self.hist_r, self.hist_i, self.theta, self.d_theta,
            p=self.p, taps=self.taps,
        )
        return yr, yi, xr.shape[-1] * self.p, self._advance(xr, xi)

    @trace.spanned("yagi.rxchain.advance")
    def _advance(self, xr, xi) -> "FusedRxChain":
        """The state after a block with planes (or plane views) xr, xi."""
        return self.replace(
            hist_r=xr[:, -128:].contiguous(),
            hist_i=xi[:, -128:].contiguous(),
            theta=(self.theta + (xr.shape[-1] * self.p) * self.d_theta) & U32,
        )

    @trace.spanned("yagi.rxchain.step", first="yagi.rxchain.first_step")
    def step(self, x):
        """Complex step: x complex64 [C, T] → (y complex64 [C, T·P], T·P,
        state), the kernel reading and writing interleaved samples, with the
        values of :meth:`step_planar`."""
        x = x.to(torch.complex64).contiguous()
        y = fused_chain_apply_c64(
            x, self.g, self.hist_r, self.hist_i, self.theta, self.d_theta,
            p=self.p, taps=self.taps,
        )
        return y, x.shape[-1] * self.p, self._advance(x.real, x.imag)

    __call__ = step
