"""QAM receiver / symbol tracker chain (BASELINE config[3]).

Port of :mod:`yagi_tpu.chains.qam` (liquid's symtrack_cccf composition): AGC
→ polyphase symbol synchronizer (2 samples/symbol out) → decision-directed
LMS equalizer → carrier-phase PLL → hard-decision demodulation, with a
running EVM.

``step_masked`` has one route, yagi_tpu's decoupled formulation
(``qam.py:276-309``): the AGC over the block (kernel ``agc_scan``), the
symsync timing loop emitting E = ``slots`` slots per input sample (kernel K3,
``symsync_fused``, at k_out = 2), then the equalizer / carrier loop over the
slots in stream order (kernel ``qam_eq_scan``). Three launches per block, no
host sync. The symsync's deferrals (an emission still due after the E
slots of a sample) add up in ``overflow_count``, as on yagi_tpu's fused
route (its decoupled route does not count them).

Left out, being TPU routing: the C < 8 edge pad, the fused-scan route and
its platform gate, ``loop_constants`` and the optimization barriers, and
the transposed [h_len, C] equalizer carry (``Eqlms`` keeps the public
[..., h_len] layout).
"""

from __future__ import annotations

import math

import torch

from .. import trace
from .._src import struct
from .._src.device import resolves_device
from ..agc import Agc
from ..design import FirFilterShape
from ..equalization import Eqlms
from ..errors import ConfigError
from ..filter import Symsync
from ..kernels.qam import qam_eq_scan_apply, qam_eq_scan_reference
from ..modem import Modem
from ..utils.compact import compact_valid

__all__ = ["QamRx"]


@struct.state
class QamRx:
    """agc → symsync → eqlms → carrier PLL → demod (symtrack semantics)."""

    k: int = struct.static_field()  # input samples/symbol
    k_eq: int = struct.static_field()  # samples/symbol into the equalizer (2)
    agc: Agc = struct.field()
    symsync: Symsync = struct.field()
    eq: Eqlms = struct.field()
    table: torch.Tensor = struct.field()  # constellation points
    alpha: torch.Tensor = struct.field()  # PLL proportional gain
    beta: torch.Tensor = struct.field()  # PLL integral gain
    theta: torch.Tensor = struct.field()  # carrier phase
    dtheta: torch.Tensor = struct.field()  # carrier frequency
    sym_phase: torch.Tensor = struct.field()  # int32 mod k_eq
    evm_accum: torch.Tensor = struct.field()
    evm_count: torch.Tensor = struct.field()
    # symsync emissions deferred past the slot capacity (should stay 0; see
    # step_masked)
    overflow_count: torch.Tensor = struct.field()
    # emission slots per input sample, each a full eq/carrier update
    slots: int = struct.static_field(default=2)

    @classmethod
    @resolves_device
    @trace.spanned("yagi.qamrx.create", always=True)
    def create(cls, ftype: str = "rrcos", k: int = 2, m: int = 7, beta: float = 0.3,
               scheme: str = "qam16", eq_len: int = 7, eq_bw: float = 0.02,
               pll_bw: float = 0.02, batch_shape: tuple = (), slots: int = 2,
               device=None) -> "QamRx":
        if k < 2:
            raise ConfigError("samples/symbol must be at least 2")
        if not 0.0 < beta <= 1.0:
            raise ConfigError("filter excess bandwidth must be in (0, 1]")
        if eq_len % 2 == 0:
            raise ConfigError("equalizer length must be odd")
        if slots < 1:
            raise ConfigError("slots must be at least 1")
        if isinstance(ftype, str):
            ftype = FirFilterShape.from_str(ftype)
        batch_shape = tuple(batch_shape)
        z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
        return cls(
            k=k,
            k_eq=2,
            # narrow AGC: wide loops track the QAM envelope itself and
            # distort the constellation
            agc=Agc.create(batch_shape=batch_shape, device=device).set_bandwidth(1e-3),
            symsync=Symsync.create_rnyquist(ftype, k, m, beta, batch_shape=batch_shape,
                                            device=device).set_output_rate(2),
            # identity init: the symsync already matched-filters, so the eq
            # starts as a pure (eq_len−1)/2-sample delay
            eq=Eqlms.create(h_len=eq_len, batch_shape=batch_shape, device=device).set_bw(eq_bw),
            table=Modem.create(scheme, device=device).table,
            alpha=torch.tensor(pll_bw, dtype=torch.float32, device=device),
            beta=torch.tensor(0.5 * pll_bw * pll_bw, dtype=torch.float32, device=device),
            theta=z,
            dtheta=z.clone(),
            # the eq's identity delay is (eq_len−1)/2 samples: start the
            # symbol-phase counter so instants line up at the eq output
            sym_phase=torch.full(batch_shape, (-((eq_len - 1) // 2)) % 2, dtype=torch.int32,
                                 device=device),
            evm_accum=z.clone(),
            evm_count=z.clone(),
            overflow_count=torch.zeros(batch_shape, dtype=torch.int32, device=device),
            slots=slots,
        )

    def reset(self) -> "QamRx":
        z = torch.zeros_like(self.theta)
        return self.replace(
            agc=self.agc.reset(),
            symsync=self.symsync.reset(),
            eq=self.eq.reset(),
            theta=z,
            dtheta=z.clone(),
            sym_phase=torch.full_like(self.sym_phase, (-((self.eq.h_len - 1) // 2)) % 2),
            evm_accum=z.clone(),
            evm_count=z.clone(),
            overflow_count=torch.zeros_like(self.overflow_count),
        )

    def set_bandwidth(self, pll_bw) -> "QamRx":
        """Carrier-loop bandwidth (symtrack set_bandwidth semantics)."""
        if isinstance(pll_bw, (int, float)) and pll_bw < 0.0:
            raise ConfigError("bandwidth must be non-negative")
        bw = torch.as_tensor(pll_bw, dtype=torch.float32, device=self.theta.device)
        return self.replace(alpha=bw, beta=0.5 * bw * bw)

    def get_evm(self):
        """Running EVM in dB over all demodulated symbols."""
        ms = self.evm_accum / torch.clamp(self.evm_count, min=1.0)
        return 10.0 * torch.log10(torch.clamp(ms, min=1e-12))

    def step_masked(self, x, samples_per_step: int | None = None):
        """Process one block x [..., n]; masked (uncompacted) outputs.

        Returns ``(syms, soft, mask, chain)``, each output ``[..., n·E]`` (E =
        ``slots`` emission slots per input sample, in stream order): ``syms``
        int64 (yagi_tpu's u32 symbols), ``soft`` complex64 (the
        carrier-corrected equalizer output), ``mask`` bool; entries where
        ``mask`` is False are padding. :meth:`step` compacts them.

        At k_out = 2 the symsync emits about one sample per input; E = 2
        slots absorb timing transients. When an emission is still due after
        the E slots (a rate below half of nominal), it is deferred to the
        next sample and counted in ``chain.overflow_count``.
        ``samples_per_step`` is checked to divide n and has no other effect.
        """
        x = torch.as_tensor(x, device=self.theta.device)
        S = 1 if samples_per_step is None else samples_per_step
        if S < 1 or x.shape[-1] % S != 0:
            raise ConfigError("samples_per_step must divide the block length")
        return self._step_masked(x, plain=False)

    def eq_scan_args(self):
        """The equalizer / carrier loop's inputs after the slots, as
        :func:`~yagi_tpu_torch.kernels.qam.qam_eq_scan_apply` takes them:
        ``(table, mu, alpha, beta, state)``, the batch flattened to C
        channels."""
        batch = self.theta.shape
        C, h_len = math.prod(batch), self.eq.h_len

        def vec(v):
            return torch.broadcast_to(v, batch).reshape(C).contiguous()

        def taps(v):
            return v.reshape(C, h_len)

        state = dict(w=taps(self.eq.w), buffer=taps(self.eq.buffer), x2=taps(self.eq.x2),
                     x2_sum=vec(self.eq.x2_sum), count=vec(self.eq.count),
                     theta=vec(self.theta), dtheta=vec(self.dtheta),
                     sym_phase=vec(self.sym_phase), evm_accum=vec(self.evm_accum),
                     evm_count=vec(self.evm_count))
        return self.table, vec(self.eq.mu), vec(self.alpha), vec(self.beta), state

    @trace.spanned("yagi.qamrx.step", first="yagi.qamrx.first_step")
    def _step_masked(self, x, plain: bool):
        """:meth:`step_masked` through the kernels, or with ``plain`` through
        every stage's plain version on any device: ``agc_scan_reference``,
        the XLA-form symsync scan (bit-identical to K3 at k = 2) and
        ``qam_eq_scan_reference``, the chain's oracle."""
        n = x.shape[-1]
        E = self.slots
        batch = self.theta.shape
        C = math.prod(batch)
        if n == 0:  # an empty block: no slots, the state stands
            dev = self.theta.device
            return (torch.zeros(batch + (0,), dtype=torch.int64, device=dev),
                    torch.zeros(batch + (0,), dtype=torch.complex64, device=dev),
                    torch.zeros(batch + (0,), dtype=torch.bool, device=dev), self)

        y0, agc = self.agc._run(x, plain)
        y, valid, ss, deferred = self.symsync._run_slots(y0, max_emit=E,
                                                         backend="xla" if plain else "auto")
        with trace.span("yagi.qamrx.eq"):
            scan = qam_eq_scan_reference if plain else qam_eq_scan_apply
            syms, soft, mask, st = scan(y.reshape(C, n * E), valid.reshape(C, n * E),
                                        *self.eq_scan_args(), k_eq=self.k_eq)
        with trace.span("yagi.qamrx.state"):
            out = batch + (n * E,)
            eq = self.eq.replace(w=st["w"].reshape(self.eq.w.shape),
                                 buffer=st["buffer"].reshape(self.eq.buffer.shape),
                                 x2=st["x2"].reshape(self.eq.x2.shape),
                                 x2_sum=st["x2_sum"].reshape(batch),
                                 count=st["count"].reshape(batch))
            new = self.replace(
                agc=agc, symsync=ss, eq=eq, theta=st["theta"].reshape(batch),
                dtheta=st["dtheta"].reshape(batch), sym_phase=st["sym_phase"].reshape(batch),
                evm_accum=st["evm_accum"].reshape(batch),
                evm_count=st["evm_count"].reshape(batch),
                overflow_count=self.overflow_count + deferred,
            )
        return syms.reshape(out), soft.reshape(out), mask.reshape(out), new

    def step(self, x):
        """Process one block (symtrack-style compacted API).

        Returns ``(syms, soft, num_syms, chain)``: ``syms`` (int64) and
        ``soft`` (complex64) have capacity n·E entries with the valid ones
        compacted to the front; ``num_syms`` (int64, on the device) counts
        them.
        """
        syms, soft, mask, new = self.step_masked(x)
        soft, num_syms = compact_valid(soft, mask)
        syms, _ = compact_valid(syms, mask)
        return syms, soft, num_syms, new

    __call__ = step
