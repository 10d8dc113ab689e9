"""Channel impairment models.

Port of :mod:`yagi_tpu.channel` (liquid-dsp's channel_cccf): multipath (a
streaming complex FIR), a carrier frequency and phase offset (an up-mix by
an ``"exact"`` oscillator), then AWGN. yagi_tpu draws the noise from a
``jax.random`` key; the port draws it from a ``torch.Generator`` the
caller passes in, or takes a draw the caller made (``noise``), so two runs
can be fed the same noise.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ..filter import FirFilter
from ..nco import Osc

__all__ = ["Channel"]


@struct.state
class Channel:
    """Composable channel impairments (liquid channel_cccf)."""

    snr_db: float = struct.static_field()
    noise_std: float = struct.static_field()
    gain: float = struct.static_field()
    has_multipath: bool = struct.static_field()
    osc: Osc = struct.field()  # carrier offset mixer
    mp: FirFilter = struct.field()  # multipath filter (identity if disabled)

    @classmethod
    def create(cls, snr_db: float = 60.0, dphi: float = 0.0, phi: float = 0.0,
               multipath_taps=None, batch_shape: tuple = (), device=None) -> "Channel":
        device = resolve_device(device)
        osc = Osc.create("exact", batch_shape=batch_shape, device=device)
        osc = osc.set_frequency(dphi).set_phase(phi)
        if multipath_taps is None:
            h = np.array([1.0 + 0j], dtype=np.complex64)
            has_mp = False
        else:
            h = np.asarray(multipath_taps, dtype=np.complex64)
            if len(h) == 0:
                raise ConfigError("multipath taps must be non-empty")
            has_mp = True
        mp = FirFilter.create(h, batch_shape=batch_shape, dtype=torch.complex64, device=device)
        return cls(snr_db=float(snr_db), noise_std=float(10.0 ** (-snr_db / 20.0)), gain=1.0,
                   has_multipath=has_mp, osc=osc, mp=mp)

    def draw_noise(self, generator: torch.Generator, shape) -> torch.Tensor:
        """A standard complex normal draw (real and imaginary parts each
        N(0, 1), complex64) on the channel's device, from ``generator``."""
        kw = dict(generator=generator, dtype=torch.float32, device=self.osc.theta.device)
        re = torch.randn(shape, **kw)
        return torch.complex(re, torch.randn(shape, **kw))

    def execute(self, generator, x, noise=None) -> tuple[torch.Tensor, "Channel"]:
        """Apply multipath → carrier offset → AWGN of std ``noise_std``.

        ``noise``, where given, is the standard complex normal draw to scale
        (shaped like x, as :meth:`draw_noise` makes it); else it is drawn
        from ``generator``.
        """
        x = torch.as_tensor(x, device=self.osc.theta.device)
        y, mp = self.mp.execute_block(x)
        y, osc = self.osc.mix_block_up(y)
        if noise is None:
            noise = self.draw_noise(generator, y.shape)
        n = noise.to(y.device, torch.complex64) * float(np.float32(self.noise_std * np.sqrt(0.5)))
        return y + n, self.replace(mp=mp, osc=osc)

    __call__ = execute
