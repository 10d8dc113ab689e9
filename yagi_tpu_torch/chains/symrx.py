"""Arbitrary-rate resampler → symbol timing recovery farm (BASELINE config[1]).

liquid's ``msresamp_crcf`` followed by ``symsync_crcf`` on every channel, as
``bench.py:160-192`` chains them: :class:`MsResamp` brings the input from
its samples a symbol to the synchronizer's k (rate 2/2.0663 by default: a
decimation with no halfband stage, so its one stage is ``Resamp``'s
256-branch PFB evaluated on the exact u32 schedule), then
:meth:`Symsync.execute_slots` recovers the symbol timing and emits k_out
samples a symbol (kernel K3 on the card). The resampler's output count is
data-dependent; it goes on to the synchronizer as a 0-d device tensor
(``n_valid``), so a step never waits on the host. The JAX package has no
such entry; ``bench.py`` chains the two by hand there.

State: the two objects' own (the resampler's PFB window and u32 phase, the
synchronizer's window and loop state). A stream cut into blocks gives one
long run's valid outputs and state.
"""

from __future__ import annotations

import torch

from .. import trace
from .._src import struct
from .._src.device import resolves_device
from ..errors import ConfigError
from ..filter import MsResamp, Symsync

__all__ = ["ResampSymsyncRx"]


@struct.state
class ResampSymsyncRx:
    """MsResamp → Symsync state (config[1])."""

    resamp: MsResamp = struct.field()
    sync: Symsync = struct.field()

    @classmethod
    @resolves_device
    @trace.spanned("yagi.symrx.create", always=True)
    def create(cls, channels: int, rate: float = 2.0 / 2.0663, as_: float = 60.0,
               ftype: str = "rrcos", k: int = 2, m: int = 7, beta: float = 0.3,
               npfb: int = 32, lf_bw: float = 0.02, k_out: int = 1,
               device=None) -> "ResampSymsyncRx":
        """``channels`` streams: the resampler at ``rate`` (``as_`` dB) and a
        ``npfb``-branch root-Nyquist synchronizer (``ftype``, k, m, β) with
        loop bandwidth ``lf_bw``, emitting ``k_out`` samples a symbol."""
        if channels < 1:
            raise ConfigError(f"number of channels ({channels}) must be at least 1")
        resamp = MsResamp.create(rate, as_=as_, batch_shape=(channels,),
                                 arbitrary_interp="farrow", device=device)
        sync = Symsync.create_rnyquist(ftype, k, m, beta, num_filters=npfb,
                                       batch_shape=(channels,), device=device)
        return cls(resamp=resamp, sync=sync.set_lf_bw(lf_bw).set_output_rate(k_out))

    @trace.spanned("yagi.symrx.step", first="yagi.symrx.first_step")
    def step_full(self, x):
        """:meth:`step`, and the resampler's output with its count:
        ``(y, valid, r, count, state)``, r [C, cap_r] zero past ``count``, a
        0-d int64 tensor on the device (what the benchmark's check holds to
        the resampler's reference, and feeds the synchronizer's)."""
        with trace.span("yagi.symrx.resamp"):
            r, count, resamp = self.resamp.execute_block(x)
        y, valid, sync = self.sync.execute_slots(r, n_valid=count)
        with trace.span("yagi.symrx.state"):
            new = self.replace(resamp=resamp, sync=sync)
        return y, valid, r, count, new

    def step(self, x: torch.Tensor):
        """One block x [C, n] complex64 → ``(y, valid, state)``: the
        synchronizer's emission slots y [C, cap, E] complex64 and their mask
        valid [C, cap, E] (a dense prefix a sample; cap the resampler's
        output capacity, of which only the first ``count`` samples emit)."""
        y, valid, _, _, new = self.step_full(x)
        return y, valid, new

    __call__ = step
