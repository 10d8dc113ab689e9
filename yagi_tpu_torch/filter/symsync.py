"""Symbol timing recovery (polyphase matched-filter synchronizer).

Port of :mod:`yagi_tpu.filter.symsync` (reference: symsync.rs). Matched and
derivative matched-filter PFBs (dMF scaled 0.06/max|h·dh|, symsync.rs:58-76);
timing error q = clamp(Re(mf*·dmf)) filtered by a first-order loop filter
(symsync.rs:196-213, 268-276); per input sample the loop emits 0..E outputs
stepping through the npfb branches with rate feedback (symsync.rs:230-266).
The feedback makes the loop serial per channel, so the scan over a block is
a kernel (:mod:`yagi_tpu_torch.kernels.symscan`), batched over channels.

State is channel-batched: ``batch_shape`` may have any rank (flattened to
C channels for the scan).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from .. import design, trace
from ..kernels.symscan import (FUSED_SMEM_LIMIT, branch_outputs, fused_fits, fused_smem_bytes,
                               symsync_fused_apply, symsync_scan_apply, symsync_scan_xla)
from ..utils.compact import compact_valid
from .firpfb import pfb_decompose

__all__ = ["Symsync"]

_MAX_EMIT = 4  # emissions per input sample never exceed ceil(1/del)+1 ≤ 4 for k ≥ 2
_BACKENDS = ("auto", "fused", "pallas", "xla")


def _auto_emit(k: int, k_out: int) -> int:
    """Per-sample emission capacity: ceil(1/δ_min)+1 slots for the factor-2
    rate-tracking range δ ≥ k/(2·k_out); an emission past the cap is
    deferred to the next input sample (b stays < npfb across the wrap), so
    nothing is dropped."""
    return max(1, min(_MAX_EMIT, math.ceil(2 * k_out / k) + 1))


@struct.state
class Symsync:
    """Symbol synchronizer state (symsync.rs:8-30)."""

    k: int = struct.static_field()  # samples/symbol (input)
    k_out: int = struct.static_field()  # samples/symbol (output)
    npfb: int = struct.static_field()
    mf: torch.Tensor = struct.field()  # [npfb, Lsub] matched filter (conv order)
    dmf: torch.Tensor = struct.field()  # [npfb, Lsub] derivative bank
    window: torch.Tensor = struct.field()  # [..., Lsub] shared input window
    # control state
    b: torch.Tensor = struct.field()  # int32 filterbank index
    bf: torch.Tensor = struct.field()
    tau: torch.Tensor = struct.field()
    tau_decim: torch.Tensor = struct.field()
    rate: torch.Tensor = struct.field()
    delta: torch.Tensor = struct.field()
    q_err: torch.Tensor = struct.field()
    q_hat: torch.Tensor = struct.field()
    decim_counter: torch.Tensor = struct.field()  # int32
    # loop filter (coefficients [3] and state [..., 2])
    pll_b: torch.Tensor = struct.field()
    pll_a: torch.Tensor = struct.field()
    pll_v: torch.Tensor = struct.field()
    rate_adjustment: torch.Tensor = struct.field()
    locked: torch.Tensor = struct.field()

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, k: int, m: int, h, batch_shape: tuple = (), dtype=torch.complex64,
               device=None) -> "Symsync":
        """From prototype h with npfb=m branches (symsync.rs:37-110)."""
        device = resolve_device(device)
        if k < 2:
            raise ConfigError("samples/symbol must be at least 2")
        if m == 0:
            raise ConfigError("number of filters must be greater than 0")
        h = np.asarray(h, dtype=np.float64)
        h_len = len(h)
        if h_len == 0:
            raise ConfigError("filter length must be greater than 0")
        if (h_len - 1) % m != 0:
            raise ConfigError("filter length must be of the form: h_len = m*k + 1")

        # derivative filter, circular centered difference (symsync.rs:58-76)
        dh = np.empty_like(h)
        dh[0] = h[1] - h[h_len - 1]
        dh[-1] = h[0] - h[h_len - 2]
        dh[1:-1] = h[2:] - h[:-2]
        dh *= 0.06 / np.max(np.abs(h * dh))

        mf = pfb_decompose(h.astype(np.float32), m)
        dmf = pfb_decompose(dh.astype(np.float32), m)

        def full(v, dt=torch.float32):
            return torch.full(batch_shape, v, dtype=dt, device=device)

        obj = cls(
            k=k,
            k_out=1,
            npfb=m,
            mf=torch.from_numpy(mf).to(device),
            dmf=torch.from_numpy(dmf).to(device),
            window=torch.zeros(batch_shape + (mf.shape[1],), dtype=dtype, device=device),
            b=full(0, torch.int32),
            bf=full(0.0),
            tau=full(0.0),
            tau_decim=full(0.0),
            rate=full(float(k)),
            delta=full(float(k)),
            q_err=full(0.0),
            q_hat=full(0.0),
            decim_counter=full(0, torch.int32),
            pll_b=torch.zeros(3, dtype=torch.float32, device=device),
            pll_a=torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=device),
            pll_v=torch.zeros(batch_shape + (2,), dtype=torch.float32, device=device),
            rate_adjustment=full(0.0),
            locked=full(False, torch.bool),
        )
        return obj.set_lf_bw(0.01)

    @classmethod
    def create_rnyquist(cls, ftype, k: int, m: int, beta: float, num_filters: int = 32,
                        **kw) -> "Symsync":
        """Root-Nyquist matched filter bank (symsync.rs:112-131); ``ftype``
        a :class:`~yagi_tpu_torch.design.FirFilterShape` or its name."""
        if isinstance(ftype, str):
            ftype = design.FirFilterShape.from_str(ftype)
        if k < 2:
            raise ConfigError("samples/symbol must be at least 2")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if beta < 0.0 or beta > 1.0:
            raise ConfigError("excess bandwidth factor must be in [0,1]")
        if num_filters == 0:
            raise ConfigError("number of filters must be greater than 0")
        h = design.fir_design_prototype(ftype, k * num_filters, m, beta, 0.0)
        return cls.create(k, num_filters, h, **kw)

    @classmethod
    def create_kaiser(cls, k: int, m: int, beta: float, num_filters: int = 32,
                      **kw) -> "Symsync":
        """Kaiser lowpass bank (symsync.rs:133-158)."""
        if k < 2:
            raise ConfigError("samples/symbol must be at least 2")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if beta <= 0.0 or beta > 1.0:
            raise ConfigError("excess bandwidth factor must be in [0,1]")
        h_len = 2 * num_filters * k * m + 1
        fc = 0.75
        h = design.fir_design_kaiser(h_len, fc / (k * num_filters), 40.0, 0.0)
        return cls.create(k, num_filters, h * (2.0 * fc), **kw)

    # ---------------------------------------------------------------- control
    def reset(self) -> "Symsync":
        r = self.k / self.k_out
        return self.replace(
            window=torch.zeros_like(self.window),
            b=torch.zeros_like(self.b),
            bf=torch.zeros_like(self.bf),
            tau=torch.zeros_like(self.tau),
            tau_decim=torch.zeros_like(self.tau_decim),
            rate=torch.full_like(self.rate, r),
            delta=torch.full_like(self.delta, r),
            q_err=torch.zeros_like(self.q_err),
            q_hat=torch.zeros_like(self.q_hat),
            decim_counter=torch.zeros_like(self.decim_counter),
            pll_v=torch.zeros_like(self.pll_v),
        )

    def lock(self) -> "Symsync":
        return self.replace(locked=torch.ones_like(self.locked))

    def unlock(self) -> "Symsync":
        return self.replace(locked=torch.zeros_like(self.locked))

    def set_output_rate(self, k_out: int) -> "Symsync":
        """Samples/symbol at the output (symsync.rs:186-194)."""
        if k_out == 0:
            raise ConfigError("output rate must be greater than 0")
        rate = self.k / k_out
        return self.replace(
            k_out=k_out,
            rate=torch.full_like(self.rate, rate),
            delta=torch.full_like(self.delta, rate),
        )

    def set_lf_bw(self, bandwidth: float) -> "Symsync":
        """Loop filter design (symsync.rs:196-213): first order, b = [β/a0,
        0, 0], a = [1, −b·α/a0, 0], so the scan reads only a[1] and b[0]."""
        if not 0.0 <= bandwidth <= 1.0:
            raise ConfigError("bandwidth must be in [0,1]")
        alpha = 1.0 - bandwidth
        beta = 0.22 * bandwidth
        a, bb = 0.5, 0.495
        a0 = 1.0 - a * alpha
        dev = self.pll_a.device
        return self.replace(
            pll_b=torch.tensor([beta / a0, 0.0, 0.0], dtype=torch.float32, device=dev),
            pll_a=torch.tensor([1.0, -bb * alpha / a0, 0.0], dtype=torch.float32, device=dev),
            rate_adjustment=torch.full_like(self.rate_adjustment, 0.5 * bandwidth),
        )

    def get_tau(self):
        return self.tau_decim

    # ------------------------------------------------------------- streaming
    def kernel_args(self) -> dict:
        """This state as the scan kernels' keyword arguments (``state``
        [9, C], ``locked``, ``radj``, ``pll_a``, ``pll_b``, ``P``, ``k_out``,
        ``k``; see :mod:`yagi_tpu_torch.kernels.symscan`), C the flattened
        batch."""
        C = math.prod(self.tau.shape)
        state = torch.stack([
            self.b.to(torch.float32), self.bf, self.tau, self.tau_decim, self.rate, self.delta,
            self.decim_counter.to(torch.float32), self.pll_v[..., 0], self.pll_v[..., 1],
        ]).reshape(9, C)
        return dict(state=state, locked=self.locked.reshape(C),
                    radj=self.rate_adjustment.reshape(C), pll_a=self.pll_a, pll_b=self.pll_b,
                    P=self.npfb, k_out=self.k_out, k=self.k)

    def taps(self) -> torch.Tensor:
        """[2P, L] float32, g[i, j] = [mf; dmf][i, L−1−j]: slot t's outputs
        are Σ_j g[i, j]·xa[t+1+j] over the window-prefixed block xa."""
        return torch.cat([self.mf, self.dmf]).flip(-1).contiguous()

    def execute_slots(self, x, samples_per_step: int | None = None,
                      max_emit: int | None = None, n_valid=None, backend: str = "auto"):
        """Synchronize a block x [..., n]; raw emission-slot output
        (symsync.rs:219-266).

        Returns ``(y_slots, valid, state)`` shaped ``[..., n, E]`` (E =
        ``max_emit``, default 2 for k = 2, k_out = 1); per input sample the
        valid slots form a dense prefix. ``n_valid`` (an int or a 0-d integer
        tensor on x's device, never read back to the host) consumes only the
        first n_valid samples, for a variable-count upstream such as
        :class:`MsResamp`: the rest neither emit nor advance the loop, and the
        window is taken at the valid end. ``samples_per_step`` is checked to
        divide n and has no other effect: the output is the same for any value
        (on the TPU it packed samples into scan steps).

        ``backend`` keeps yagi_tpu's names; what each runs here:

        * ``"fused"``: kernel K3 (``symsync_fused_apply``), the selected
          branch's dots in the kernel, on CUDA tensors. K3 stages the whole
          bank in shared memory; a bank past the card's limit per block
          (``kernels.symscan.fused_fits``; 64 filters of 173 taps, say) raises
          :class:`ConfigError`;
        * ``"auto"``: ``"fused"`` where the bank fits, else ``"pallas"``, chosen
          from the shape before any launch; the two give the same bits;
        * ``"pallas"``: kernel K4 (``symsync_scan_apply``) over the all-branch
          stream from :func:`~yagi_tpu_torch.kernels.symscan.branch_outputs`,
          on CUDA tensors;
        * ``"xla"``: the plain torch scan that follows yagi_tpu's XLA scan,
          on any device: the oracle.

        On CPU tensors every backend runs plain torch (each kernel's plain
        version). All routes sum the filter dots in one order (K3's; see
        :mod:`yagi_tpu_torch.kernels.symscan`), so for k = 2 (where K3 and K4
        scale by 1/k and the XLA scan divides by k) they agree bit for bit.
        """
        return self._run_slots(x, samples_per_step, max_emit, n_valid, backend)[:3]

    @trace.spanned("yagi.symsync.run")
    def _run_slots(self, x, samples_per_step=None, max_emit=None, n_valid=None,
                   backend: str = "auto"):
        """:meth:`execute_slots` plus the deferral count: returns ``(y_slots,
        valid, state, deferred)``, ``deferred`` int32 [...] on the device, the
        valid samples after whose ``max_emit`` slots an emission was still
        due (deferred to the next sample; ``QamRx.overflow_count`` adds it)."""
        if backend not in _BACKENDS:
            raise ConfigError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        n = x.shape[-1]
        S = 1 if samples_per_step is None else samples_per_step
        if S < 1 or n % S != 0:
            raise ConfigError("samples_per_step must divide the block length")
        E = _auto_emit(self.k, self.k_out) if max_emit is None else max_emit
        batch = self.tau.shape
        C = math.prod(batch)
        L = self.mf.shape[1]
        dev = self.tau.device

        if n == 0:  # an empty block: no slots, the state stands
            dt = torch.complex64 if self.window.is_complex() else torch.float32
            return (torch.zeros(batch + (0, E), dtype=dt, device=dev),
                    torch.zeros(batch + (0, E), dtype=torch.bool, device=dev), self,
                    torch.zeros(batch, dtype=torch.int32, device=dev))
        xa = torch.cat([self.window.reshape(C, L), x.reshape(C, n).to(self.window.dtype)], -1)
        if n_valid is not None:
            n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
        kw = self.kernel_args()
        xc = xa.to(torch.complex64)
        fits = fused_fits(L, self.npfb)  # K3 can stage this bank in a block's shared memory
        if backend == "fused" and not fits:
            raise ConfigError(
                f"backend='fused': L = {L} taps on P = {self.npfb} filters need "
                f"{fused_smem_bytes(L, self.npfb)} bytes of shared memory a block, past the "
                f"limit of {FUSED_SMEM_LIMIT}; use 'auto' or 'pallas'")
        if backend == "auto":
            backend = "fused" if fits else "pallas"
        if backend == "fused":
            y, valid, st, deferred = symsync_fused_apply(xc, self.taps(), n_valid, E=E, **kw)
        elif backend == "pallas":
            y, valid, st, deferred = symsync_scan_apply(branch_outputs(xc, self.taps()), n_valid,
                                                        E=E, **kw)
        else:
            y, valid, st, deferred = symsync_scan_xla(branch_outputs(xc, self.taps()), n_valid,
                                                      E=E, **kw)

        if n_valid is None:
            new_window = xa[:, n:]
        else:  # the L samples ending at the last valid one
            new_window = xa[:, n_valid.clamp(0, n) + torch.arange(L, device=dev)]
        b, bf, tau, tau_d, rate, delta, dec, pv0, pv1 = st.reshape((9,) + batch).unbind(0)
        new = self.replace(
            window=new_window.reshape(self.window.shape),
            b=b.to(torch.int32), bf=bf, tau=tau, tau_decim=tau_d, rate=rate, delta=delta,
            decim_counter=dec.to(torch.int32), pll_v=torch.stack([pv0, pv1], -1),
        )
        if not self.window.is_complex():
            y = y.real
        return (y.reshape(batch + (n, E)), valid.reshape(batch + (n, E)), new,
                deferred.reshape(batch))

    def execute(self, x):
        """Synchronize a block (symsync.rs:219-266). Returns (y, num_output,
        state): y of capacity n·E with the valid outputs compacted to the
        front, num_output on the device."""
        n = x.shape[-1]
        yt, vt, new = self.execute_slots(x)
        E = yt.shape[-1]
        y, num_output = compact_valid(yt.reshape(yt.shape[:-2] + (n * E,)),
                                      vt.reshape(vt.shape[:-2] + (n * E,)))
        return y, num_output, new

    __call__ = execute
