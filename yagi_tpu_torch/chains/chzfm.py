"""FM-band channelizer farm (BASELINE config[4]): a 64-channel polyphase
analysis bank, then an FM discriminator on every channel.

liquid's ``firpfbch_crcf_create_kaiser(LIQUID_ANALYZER, 64, m, As)`` followed
by ``freqdem_create(kf)`` on each channel, as ``bench.py:85-125`` runs it:
the channelizer is :class:`FusedChannelizer`'s bank (planar step-major
[T, 64] output) and the discriminator is Freqdem's formula (freqdem.rs:35),
arg(conj(r[t−1])·r[t]) / (2π·kf), taken along the step axis of the channel
planes, with row 0 against each channel's carried last sample. A step is
one call of ``fused_channelizer_apply`` with its FM argument: on the card one
launch of K2's FM instance writes the channels, the discriminator and the new
state (``kernels/channelizer.py``); past 64 taps a branch, and on the CPU,
the channelizer and then the discriminator's plain version. The JAX package
has no such entry; ``bench.py`` chains the two by hand there.

State: the channelizer's raw input history and each channel's last complex
output, ``r_prime`` [64], zeros at the stream's start (Freqdem's). A stream
cut into blocks gives one long run's outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ..kernels.channelizer import fused_channelizer_apply
from ..multichannel import FusedChannelizer

__all__ = ["ChannelizerFmRx"]


@struct.state
class ChannelizerFmRx:
    """Channelizer → FM discriminator state (config[4])."""

    kf: float = struct.static_field()
    chz: FusedChannelizer = struct.field()
    r_prime: torch.Tensor = struct.field()  # [64] complex64: each channel's last output

    @classmethod
    @trace.spanned("yagi.chzfm.create", always=True)
    def create(cls, num_channels: int = 64, m: int = 4, as_: float = 60.0, kf: float = 0.1,
               device=None) -> "ChannelizerFmRx":
        device = resolve_device(device)
        if kf <= 0.0:
            raise ConfigError(f"modulation factor {kf:.4e} must be greater than 0")
        chz = FusedChannelizer.create_kaiser(num_channels, m, as_, device=device)
        return cls(kf=float(kf), chz=chz,
                   r_prime=torch.zeros(num_channels, dtype=torch.complex64, device=device))

    @property
    def ref(self) -> float:
        """Freqdem's float32 scale 1/(2π·kf) (freqdem.rs:41)."""
        return float(np.float32(1.0 / (2.0 * np.pi * self.kf)))

    @trace.spanned("yagi.chzfm.step")
    def step(self, xr, xi):
        """One block of the wideband stream as planar float32 planes xr, xi
        [N] (N = 64·T, a multiple of 16,384) → ``(yr, yi, fm, state)``: the
        channels as K2 writes them, [T, 64] step-major, and the discriminator
        output fm [T, 64] float32, step-major."""
        chz = self.chz
        with trace.span("yagi.chzfm.channelize"):
            yr, yi, fm, r_prime, hist_r, hist_i = fused_channelizer_apply(
                xr, xi, chz.taps, chz.hr, chz.hi, chz.hist_r, chz.hist_i, p=chz.p, r2=chz.r2,
                fm=(self.r_prime, self.ref))
        with trace.span("yagi.chzfm.state"):
            new = self.replace(chz=chz.replace(hist_r=hist_r, hist_i=hist_i), r_prime=r_prime)
        return yr, yi, fm, new

    __call__ = step
