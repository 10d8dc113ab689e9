"""FM-band channelizer farm (BASELINE config[4]): a 64-channel polyphase
analysis bank, then an FM discriminator on every channel.

liquid's ``firpfbch_crcf_create_kaiser(LIQUID_ANALYZER, 64, m, As)`` followed
by ``freqdem_create(kf)`` on each channel, as ``bench.py:85-125`` runs it:
the channelizer is :class:`FusedChannelizer` (one K2 launch a block, planar
step-major [T, 64] output) and the discriminator is Freqdem's formula
(freqdem.rs:35), arg(conj(r[t−1])·r[t]) / (2π·kf), taken along the step axis
of K2's planes, with row 0 against each channel's carried last sample. The
JAX package has no such entry; ``bench.py`` chains the two by hand there.

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
from ..multichannel import FusedChannelizer

__all__ = ["ChannelizerFmRx"]


def _phase_step(pr, pi, rr, ri, out: torch.Tensor) -> torch.Tensor:
    """``out`` = atan2(pr·ri − pi·rr, pr·rr + pi·ri) = arg(conj(r′)·r),
    elementwise, from the planes of r′ (pr, pi) and r (rr, ri)."""
    im = pr * ri
    im.addcmul_(pi, rr, value=-1.0)
    re = pr * rr
    re.addcmul_(pi, ri)
    return torch.atan2(im, re, out=out)


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
        with trace.span("yagi.chzfm.channelize"):
            yr, yi, chz = self.chz.analyzer_execute_planar(xr, xi)
        with trace.span("yagi.chzfm.demod"):
            fm = torch.empty_like(yr)
            _phase_step(self.r_prime.real, self.r_prime.imag, yr[0], yi[0], fm[0])
            _phase_step(yr[:-1], yi[:-1], yr[1:], yi[1:], fm[1:])
            fm.mul_(self.ref)
        with trace.span("yagi.chzfm.state"):
            new = self.replace(chz=chz, r_prime=torch.complex(yr[-1], yi[-1]))
        return yr, yi, fm, new

    __call__ = step
