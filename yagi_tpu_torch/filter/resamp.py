"""Arbitrary-rate polyphase resampler.

Port of :mod:`yagi_tpu.filter.resamp` (reference: resamp.rs). The reference
advances a u32 fixed-point phase per input sample (step = round(2^24 / r),
resamp.rs:103) and emits one output per phase slot through a selected PFB
branch (resamp.rs:141-154).

Closed form: output m has the 64-bit accumulated phase P_m = phase0 + m·step
and is emitted while consuming input n_m = P_m >> 24 through branch
(P_m & 0xffffff) >> (24 − bits). torch's int64 holds P_m exactly, so the
schedule, the count and the carried phase equal the reference's u32
semantics. Outputs come from ``kernels/resamp.py::resamp_u32_apply``: one
launch of ``csrc/resamp.cu`` on the card, which forms each output from the
schedule on chip, and on the CPU its plain version, a frame gather plus one
batched contraction; or, while the schedule is provably periodic with phase 0
at block edges, one banded matmul (filter/_sched.py).

With ``interp="farrow"`` the values come from the prototype FIR and a
designed Farrow interpolator at the exact u32 times
(filter/_farrow_resamp.py), yagi_tpu's production mode for truly arbitrary
rates: the schedule, counts and state stay the u32 ones.

Because the output count depends on the carried phase, the block calls return
a fixed-capacity buffer plus the exact count.
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.struct import U32
from .._src.window import carry
from ..errors import ConfigError
from .. import design
from ..math.special import nextpow2
from ..nco.osc import _rotate_down
from ._farrow_resamp import farrow_resample_values
from ..kernels.resamp import resamp_u32_apply, u32_schedule
from ._sched import sched_banded_matmul, sched_matmul_ok, u32_static_schedule
from .firpfb import pfb_decompose

__all__ = ["Resamp"]


def _pq_of_step(step: int) -> tuple | None:
    """(P, Q) of the exactly-periodic u32 schedule, or None."""
    if step <= 0:
        return None
    g = math.gcd(step, 1 << 24)
    p = (1 << 24) // g
    return (p, step // g) if p <= 256 else None


@struct.state
class Resamp:
    """Arbitrary resampler state (resamp.rs:8-16)."""

    m: int = struct.static_field()  # filter semi-length (delay)
    bits: int = struct.static_field()  # log2(npfb)
    nominal_rate: float = struct.static_field()  # create-time rate, sizes buffers
    branches: torch.Tensor = struct.field()  # [npfb, Lsub] convolution order
    rate: torch.Tensor = struct.field()  # float32 current rate
    step: torch.Tensor = struct.field()  # u32 = round(2^24 / rate), int64
    phase: torch.Tensor = struct.field()  # u32 accumulator, int64
    window: torch.Tensor = struct.field()  # [..., Lsub] PFB window
    # (P, Q) when the u32 schedule is exactly periodic (P | 2^24) AND the
    # carried phase is provably 0 at every block boundary so far: the
    # banded-matmul fast path applies. Cleared (None) by a block that can
    # leave a nonzero phase.
    exact_sched: tuple | None = struct.static_field(default=None)
    # prototype cutoff (create-time fc; sizes the Farrow design band)
    fc: float = struct.static_field(default=0.25)
    # "pfb": the reference's 256-branch evaluation (banded fast path while
    # exact_sched holds, else the u32 frame gather). "farrow": the prototype
    # FIR and a designed polynomial interpolator at the exact u32 times
    # (filter/_farrow_resamp.py), values within the reference's own 1/256
    # branch rounding
    interp: str = struct.static_field(default="pfb")
    # the u32 step as a host int while it is known there (create, set_rate
    # with a Python number, reset back to the nominal step); the Farrow
    # path sizes its exact head and tail from it, and without it runs the
    # PFB gather
    step_cert: int | None = struct.static_field(default=None)

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(
        cls,
        rate: float,
        m: int = 7,
        fc: float = 0.25,
        as_: float = 60.0,
        npfb: int = 256,
        batch_shape: tuple = (),
        dtype=torch.complex64,
        interp: str = "pfb",
        device=None,
    ) -> "Resamp":
        """Design the PFB prototype and initialize state (resamp.rs:24-71).

        ``interp="farrow"`` selects the Farrow values for :meth:`execute_block`
        (see the field comment); :meth:`execute_block_n` runs the PFB gather
        for either mode, as yagi_tpu's does.
        """
        device = resolve_device(device)
        if interp not in ("pfb", "farrow"):
            raise ConfigError("interp must be 'pfb' or 'farrow'")
        if rate <= 0.0:
            raise ConfigError("resampling rate must be greater than zero")
        if m == 0:
            raise ConfigError("filter semi-length must be greater than zero")
        if fc <= 0.0 or fc >= 0.5:
            raise ConfigError("filter cutoff must be in (0,0.5)")
        if as_ <= 0.0:
            raise ConfigError("filter stop-band suppression must be greater than zero")
        bits = nextpow2(npfb)
        if bits < 1 or bits > 16:
            raise ConfigError("number of filter banks must be in (2^0,2^16)")
        npfb = 1 << bits

        n = 2 * m * npfb + 1
        hf = design.fir_design_kaiser(n, fc / npfb, as_, 0.0)
        h = (hf * (npfb / np.sum(hf))).astype(np.float32)
        # the reference constructs the PFB with h_len = n-1 (drops last tap)
        branches = pfb_decompose(h[: n - 1], npfb)
        step = int(np.round((1 << 24) / rate))
        obj = cls(
            m=m,
            bits=bits,
            nominal_rate=float(rate),
            branches=torch.from_numpy(branches).to(device),
            rate=torch.tensor(rate, dtype=torch.float32, device=device),
            step=torch.tensor(step & U32, dtype=torch.int64, device=device),
            phase=torch.zeros((), dtype=torch.int64, device=device),
            window=torch.zeros(
                batch_shape + (branches.shape[1],), dtype=dtype, device=device
            ),
            exact_sched=_pq_of_step(step),
            fc=float(fc),
            interp=interp,
            step_cert=step,
        )
        return obj._check_rate(rate)

    @classmethod
    def create_default(cls, rate: float, **kw) -> "Resamp":
        """Default parameters (resamp.rs:73-84)."""
        return cls.create(rate, m=7, fc=0.25, as_=60.0, npfb=256, **kw)

    def _check_rate(self, rate: float) -> "Resamp":
        if rate <= 0.0:
            raise ConfigError("resampling rate must be greater than zero")
        if rate < 0.004 or rate > 250.0:
            raise ConfigError("resampling rate must be in [0.004,250]")
        return self

    # ------------------------------------------------------------- properties
    @property
    def npfb(self) -> int:
        return self.branches.shape[0]

    @property
    def sub_len(self) -> int:
        return self.branches.shape[1]

    def get_delay(self) -> int:
        return self.m

    def get_rate(self):
        return self.rate

    # ---------------------------------------------------------------- control
    def reset(self) -> "Resamp":
        """Phase and window to 0. With the phase 0 again, the static-schedule
        certificate and the Farrow step come back when the step still
        equals the create-time nominal step (reads the step back once)."""
        sched, cert = self.exact_sched, self.step_cert
        if sched is None:
            nominal = int(np.round((1 << 24) / self.nominal_rate))
            if int(self.step) == nominal:
                sched, cert = _pq_of_step(nominal), nominal
        return self.replace(phase=torch.zeros_like(self.phase),
                            window=torch.zeros_like(self.window),
                            exact_sched=sched, step_cert=cert)

    def set_rate(self, rate) -> "Resamp":
        """Update the rate; step = round(2^24 / r) (resamp.rs:95-106).

        A Python number is range-checked and rounded in float64 as in
        :meth:`create`, and certifies the step for the Farrow path; a tensor
        (a rate computed on the device) is rounded in float32 and leaves the
        step uncertified. Either clears ``exact_sched``: the carried phase
        may be nonzero.
        """
        dev = self.rate.device
        if isinstance(rate, (int, float)):
            self._check_rate(float(rate))
            cert = int(np.round((1 << 24) / float(rate)))
            r = torch.tensor(rate, dtype=torch.float32, device=dev)
            step = torch.tensor(cert & U32, dtype=torch.int64, device=dev)
        else:
            cert = None
            r = torch.as_tensor(rate, dtype=torch.float32, device=dev)
            step = torch.round((1 << 24) / r).to(torch.int64).clamp(0, U32)
        return self.replace(rate=r, step=step, exact_sched=None, step_cert=cert)

    def adjust_rate(self, gamma) -> "Resamp":
        """Multiplicative rate adjustment (resamp.rs:112)."""
        return self.set_rate(
            self.rate * torch.as_tensor(gamma, dtype=torch.float32, device=self.rate.device))

    def get_num_output(self, num_input: int) -> int:
        """Exact output count for the next num_input samples (resamp.rs:128);
        host-side, reads the carried phase back."""
        phase, step = int(self.phase), int(self.step)
        end = num_input << 24
        if phase > end - 1:
            return 0
        return (end - 1 - phase) // step + 1

    def out_capacity(self, num_input: int, rate_hint: float | None = None) -> int:
        """Static output-buffer capacity for a block of num_input samples,
        sized from the create-time nominal rate, rounded up to a multiple
        of 8."""
        r = self.nominal_rate if rate_hint is None else rate_hint
        return -(-(int(np.ceil(num_input * r)) + 4) // 8) * 8

    # -------------------------------------------------------------- internals
    def _static_fast(self, xa, n: int, out_capacity: int):
        """Static-schedule banded-matmul resample, or None if inapplicable.

        Valid only while ``exact_sched`` certifies the u32 phase is 0 at
        every block boundary. Returns ``(y, n_out)`` with ``y`` zero-padded
        to ``out_capacity``.
        """
        if self.exact_sched is None:
            return None
        p_s, q_s = self.exact_sched
        n_out = (n // q_s) * p_s
        if n % q_s != 0 or n_out > out_capacity:
            return None
        if not sched_matmul_ok(p_s, q_s, self.sub_len):
            return None
        sched = u32_static_schedule(
            int(np.round((1 << 24) / self.nominal_rate)), self.bits, self.npfb
        )
        if sched is None:
            return None
        _, _, src_off, br_idx = sched
        y = sched_banded_matmul(xa, self.branches, src_off, br_idx, q_s, n // q_s)
        pad = out_capacity - n_out
        if pad:
            y = torch.nn.functional.pad(y, (0, pad))
        return y, n_out

    def _keeps_sched(self, n: int, out_capacity: int):
        """exact_sched after a block of n inputs: kept only when the block
        consumed whole schedule periods within capacity."""
        s = self.exact_sched
        if s is not None and n % s[1] == 0 and (n // s[1]) * s[0] <= out_capacity:
            return s
        return None

    def _u32(self, x, n_valid, out_capacity: int):
        """The u32 PFB gather over block ``x`` of which the first ``n_valid``
        are consumed: ``resamp_u32_apply`` (one kernel launch on the card, its
        plain torch version on the CPU) → (y zero past the count, count,
        new_phase, new_window)."""
        return resamp_u32_apply(x, self.window, self.branches, self.phase, self.step, n_valid,
                                out_capacity=out_capacity)

    def _empty(self, x, out_capacity: int):
        """An empty block's result: out_capacity zeros and a count of 0."""
        dt = torch.promote_types(x.dtype, self.branches.dtype)
        return (torch.zeros(x.shape[:-1] + (out_capacity,), dtype=dt, device=x.device),
                torch.zeros((), dtype=torch.int64, device=x.device))

    # ------------------------------------------------------------- streaming
    def execute_block(self, x, out_capacity: int | None = None):
        """Resample a block (resamp.rs:156-165).

        Returns (y, num_output, state): y has static length ``out_capacity``
        with valid samples in y[..., :num_output] and zeros beyond. A block
        of 0 samples returns zeros and a count of 0 and keeps the state.
        """
        x = torch.as_tensor(x, device=self.window.device)
        n = x.shape[-1]
        if out_capacity is None:
            out_capacity = self.out_capacity(n)
        if n == 0:
            return (*self._empty(x, out_capacity), self)
        farrow = self.interp == "farrow" and self.step_cert is not None
        if self.exact_sched is not None or farrow:
            xa = torch.cat([self.window[..., 1:].to(x.dtype), x], dim=-1)
            new_window = carry(self.window, xa)
            fast = self._static_fast(xa, n, out_capacity)
            if fast is not None:
                y, n_out = fast
                count = torch.full((), n_out, dtype=torch.int64, device=x.device)
                return y, count, self.replace(window=new_window)
        if farrow:
            n_m, branch, lo, valid, num_output, new_phase = u32_schedule(
                self.phase, self.step, self.bits, out_capacity, n)
            y = farrow_resample_values(xa, self.branches, self.step_cert, n, n_m, branch, lo,
                                       valid, band=round(min(0.42, 1.4 * self.fc), 3))
        else:
            y, num_output, new_phase, new_window = self._u32(x, n, out_capacity)
        return y, num_output, self.replace(
            phase=new_phase,
            window=new_window,
            exact_sched=self._keeps_sched(n, out_capacity),
        )

    __call__ = execute_block

    def execute(self, x_one):
        """One input sample [...] (resamp.rs:141): (y [..., cap], count, state)."""
        x_one = torch.as_tensor(x_one, device=self.window.device)
        return self.execute_block(x_one[..., None])

    def execute_block_n(self, x, n_valid, out_capacity: int | None = None):
        """Valid-prefix variant of :meth:`execute_block`: only the first
        ``n_valid`` samples of the fixed-capacity buffer ``x`` [..., cap] are
        consumed (x is masked past them). ``n_valid`` is an int in [0, cap] or
        a 0-d integer tensor on x's device; it is never read back to the host.

        The u32 phase advances by exactly the emissions a sequential run
        over those samples would make (resamp.rs:141-154), the PFB window
        lands at the valid end, and ``exact_sched`` is cleared. Always the
        u32 PFB gather (``resamp_u32_apply``), for either ``interp``, as in
        yagi_tpu. Returns
        (y, num_output, state) with y zero beyond num_output.
        """
        if out_capacity is None:
            out_capacity = self.out_capacity(x.shape[-1])
        if isinstance(n_valid, torch.Tensor):
            n_valid = n_valid.to(device=x.device, dtype=torch.int64)
        else:
            n_valid = operator.index(n_valid)
        y, num_output, new_phase, new_window = self._u32(x, n_valid, out_capacity)
        return y, num_output, self.replace(phase=new_phase, window=new_window, exact_sched=None)

    def execute_block_mix_down(self, x, osc, out_capacity: int | None = None):
        """Resample then NCO down-mix in one pass.

        Equal to ``execute_block`` followed by ``osc.mix_block_down_n`` (same
        integer schedule, same u32 phase ramp, same sin/cos). Returns
        ``(y_mixed, num_output, new_resamp, new_osc)``.
        """
        n = x.shape[-1]
        if out_capacity is None:
            out_capacity = self.out_capacity(n)
        if n == 0:  # an empty block: zeros, a count of 0, both states stand
            return (*self._empty(x, out_capacity), self, osc)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if self.exact_sched is not None:
            xa = torch.cat([self.window[..., 1:].to(x.dtype), x], dim=-1)
            fast = self._static_fast(xa, n, out_capacity)
            if fast is not None:
                yf, n_out = fast
                m_valid = torch.arange(out_capacity, device=x.device) < n_out
                yf = torch.where(m_valid,
                                 _rotate_down(yf, osc._phase_ramp(out_capacity), osc.mode), zero)
                count = torch.full((), n_out, dtype=torch.int64, device=x.device)
                return (yf, count, self.replace(window=carry(self.window, xa)),
                        osc._advance(n_out))

        y, num_output, new_phase, new_window = self._u32(x, n, out_capacity)
        valid = torch.arange(out_capacity, device=x.device) < num_output
        y = torch.where(valid, _rotate_down(y, osc._phase_ramp(out_capacity), osc.mode), zero)
        return (
            y,
            num_output,
            self.replace(
                phase=new_phase,
                window=new_window,
                exact_sched=self._keeps_sched(n, out_capacity),
            ),
            osc._advance(num_output),
        )
