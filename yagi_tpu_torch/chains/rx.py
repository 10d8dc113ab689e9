"""Baseline receive chain: FIR lowpass → arbitrary resampler → NCO mix.

Port of :mod:`yagi_tpu.chains.rx`: BASELINE config[0] ("64-tap firfilt
low-pass + resamp 2x + NCO mix") as one state object with a ``step``. It
carries all stream state, so consecutive ``step`` calls equal one long run.
Plain torch stages; it is the parity oracle of :class:`FusedRxChain`.
"""

from __future__ import annotations

import torch

from .._src import struct
from .._src.device import resolve_device
from ..filter import FirFilter, Resamp
from ..nco import Osc

__all__ = ["RxChain"]


@struct.state
class RxChain:
    """firfilt → resamp → mix_down chain state."""

    fir: FirFilter = struct.field()
    resamp: Resamp = struct.field()
    osc: Osc = struct.field()

    @classmethod
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
        osc_mode: str = "exact",
        device=None,
    ) -> "RxChain":
        device = resolve_device(device)
        fir = FirFilter.create_kaiser(
            n_taps, fc, as_, 0.0, batch_shape=batch_shape, dtype=torch.complex64,
            device=device,
        ).set_scale(2 * fc)
        rs = Resamp.create(rate, m=m, npfb=npfb, batch_shape=batch_shape, device=device)
        osc = Osc.create(osc_mode, device=device).set_frequency(mix_freq)
        return cls(fir=fir, resamp=rs, osc=osc)

    def step(self, x) -> tuple[torch.Tensor, torch.Tensor, "RxChain"]:
        """Process one block: returns (y, num_valid, new_chain).

        ``y`` has length ``resamp.out_capacity(T)``; its first ``num_valid``
        samples are valid and zeros follow.
        """
        y0, fir = self.fir.execute_block(x)
        y2, k, rs, osc = self.resamp.execute_block_mix_down(y0, self.osc)
        return y2, k, self.replace(fir=fir, resamp=rs, osc=osc)

    __call__ = step
