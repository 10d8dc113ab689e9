"""Multi-stage arbitrary resampler.

Port of :mod:`yagi_tpu.filter.msresamp` (reference: msresamp.rs). The rate is
decomposed into halfband stages (bringing it into [0.5, 2]) plus one
arbitrary-rate :class:`Resamp` stage (msresamp.rs:28-80). Interpolation runs
arbitrary → halfbands; decimation runs halfbands → arbitrary
(msresamp.rs:129-164).

``execute_block`` keeps every count on the device: the arbitrary stage's
data-dependent sample count threads through the halfband chain as a 0-d
tensor (the valid-prefix convention), and the decimation branch's carry of
ungrouped samples is placed and taken with device-side indices, so a stream
of blocks never waits on the host. A decimation with no halfband stage
groups samples by 1 and never carries one: its block goes to the arbitrary
stage as it is (one kernel launch on the card). ``execute`` is the
host-compacting convenience wrapper.

With ``arbitrary_interp="farrow"`` an interpolating MsResamp's arbitrary
stage (``Resamp.execute_block``) takes its values from the prototype FIR and
a Farrow interpolator at the exact u32 times (filter/_farrow_resamp.py); a
decimating one runs as yagi_tpu's does: its arbitrary stage is
``Resamp.execute_block_n``, the 256-branch PFB gather, whatever ``interp``
says.
"""

from __future__ import annotations

import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from .msresamp2 import MsResamp2
from .resamp import Resamp

__all__ = ["MsResamp"]


@struct.state
class MsResamp:
    """Composite resampler state (msresamp.rs:10-20)."""

    rate: float = struct.static_field()
    interp: bool = struct.static_field()
    rate_arbitrary: float = struct.static_field()
    num_halfband_stages: int = struct.static_field()
    halfband: MsResamp2 = struct.field()
    arbitrary: Resamp = struct.field()
    # decim path: carried samples waiting to fill a 2^k group
    carry: torch.Tensor = struct.field()  # [..., 2^k]
    carry_len: torch.Tensor = struct.field()  # 0-d integer

    @classmethod
    def create(cls, rate: float, as_: float = 60.0, batch_shape: tuple = (),
               dtype=torch.complex64, arbitrary_interp: str = "pfb",
               device=None) -> "MsResamp":
        """Rate decomposition per msresamp.rs:28-80."""
        device = resolve_device(device)
        if rate <= 0.0:
            raise ConfigError("resampling rate must be greater than zero")
        interp = rate > 1.0
        rate_arbitrary = rate
        num_hb = 0
        if interp:
            while rate_arbitrary > 2.0:
                num_hb += 1
                rate_arbitrary *= 0.5
        else:
            while rate_arbitrary < 0.5:
                num_hb += 1
                rate_arbitrary *= 2.0
        halfband = MsResamp2.create(interp, num_hb, 0.4, 0.0, as_, batch_shape=batch_shape,
                                    dtype=dtype, device=device)
        arbitrary = Resamp.create(
            rate_arbitrary,
            m=7,
            fc=min(0.515 * rate_arbitrary, 0.49),
            as_=as_,
            npfb=256,
            batch_shape=batch_shape,
            dtype=dtype,
            interp=arbitrary_interp,
            device=device,
        )
        return cls(
            rate=float(rate),
            interp=interp,
            rate_arbitrary=float(rate_arbitrary),
            num_halfband_stages=num_hb,
            halfband=halfband,
            arbitrary=arbitrary,
            carry=torch.zeros(batch_shape + (1 << num_hb,), dtype=dtype, device=device),
            carry_len=torch.zeros((), dtype=torch.int64, device=device),
        )

    def reset(self) -> "MsResamp":
        return self.replace(
            halfband=self.halfband.reset(),
            arbitrary=self.arbitrary.reset(),
            carry=torch.zeros_like(self.carry),
            carry_len=torch.zeros_like(self.carry_len),
        )

    def get_rate(self) -> float:
        return self.rate

    def get_delay(self) -> float:
        """Composite delay (msresamp.rs:91-105)."""
        dh = self.halfband.get_delay()
        da = float(self.arbitrary.get_delay())
        if self.num_halfband_stages == 0:
            return da
        if self.interp:
            return dh / self.rate_arbitrary + da
        return dh + (1 << self.num_halfband_stages) * da

    def get_num_output(self, num_input: int) -> int:
        """Exact output count (msresamp.rs:113-124); host-side, reads the
        carried phase and carry length back."""
        if self.interp:
            n = self.arbitrary.get_num_output(num_input)
            return n * (1 << self.num_halfband_stages)
        n = (int(self.carry_len) + num_input) >> self.num_halfband_stages
        return self.arbitrary.get_num_output(n)

    def out_capacity(self, num_input: int) -> int:
        """Static output-buffer capacity for :meth:`execute_block`."""
        if self.interp:
            return self.arbitrary.out_capacity(num_input) << self.num_halfband_stages
        m = 1 << self.num_halfband_stages
        return self.arbitrary.out_capacity((num_input + m) >> self.num_halfband_stages)

    def execute_block(self, x):
        """Resample a block x [..., n] (msresamp.rs:126-164).

        Returns (y, num_output, state): y has the fixed capacity
        :meth:`out_capacity` (n) with zeros beyond ``num_output``, a 0-d int64
        tensor on x's device.
        """
        n = x.shape[-1]
        dev = x.device
        if self.interp:
            # arbitrary stage first (low rate), then the halfband interp chain
            y1, k, arb = self.arbitrary.execute_block(x)
            y2, k2, hb = self.halfband.execute_block_n(y1, k)
            return y2, k2, self.replace(arbitrary=arb, halfband=hb)

        if self.num_halfband_stages == 0:
            # groups of 2^0 = 1 leave no carry: the arbitrary stage takes the
            # block as it is, at the capacity of the carry path's buffer
            cap = self.out_capacity(n)
            if n == 0:  # as the carry path: zeros, a count of 0, the schedule's mark cleared
                return (*self.arbitrary._empty(x, cap),
                        self.replace(arbitrary=self.arbitrary.replace(exact_sched=None)))
            y, k, arb = self.arbitrary.execute_block_n(x, n, out_capacity=cap)
            return y, k, self.replace(arbitrary=arb)

        # decimation: carry + input into one valid-prefix buffer, grouped into
        # multiples of 2^k for the halfband chain, then the arbitrary stage
        m = 1 << self.num_halfband_stages
        cl = self.carry_len.to(torch.int64)
        capb = -(-(n + m) // m) * m  # static capacity, multiple of 2^k
        batch = x.shape[:-1]
        carry_pad = torch.cat(
            [self.carry.to(x.dtype), x.new_zeros(batch + (capb - m,))], dim=-1)
        # the new block placed at the carry's valid end
        xext = torch.cat([x.new_zeros(batch + (m,)), x, x.new_zeros(batch + (capb - n,))], dim=-1)
        pos = torch.arange(capb, device=dev)
        xshift = xext[..., (m - cl) + pos]
        buf = torch.where(pos >= cl, xshift, carry_pad)
        total = cl + n
        rem = total % m
        n_groups_samples = total - rem
        y1, k1, hb = self.halfband.execute_block_n(buf, n_groups_samples)
        y2, k2, arb = self.arbitrary.execute_block_n(y1, k1)
        # carry = the rem ungrouped samples at the valid end
        pos_m = torch.arange(m, device=dev)
        new_carry = buf[..., n_groups_samples.clamp(0, capb - m) + pos_m]
        new_carry = torch.where(pos_m < rem, new_carry, x.new_zeros(()))
        return y2, k2, self.replace(halfband=hb, arbitrary=arb, carry=new_carry,
                                    carry_len=rem)

    def execute(self, x):
        """Resample a block; returns a compact tensor of exactly
        ``get_num_output(n)`` samples and the new state (reads the count
        back to the host)."""
        y, k, new = self.execute_block(x)
        return y[..., : int(k)], new

    __call__ = execute
