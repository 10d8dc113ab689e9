"""Streaming infinite impulse response filter.

Port of :mod:`yagi_tpu.filter.iirfilt` (reference: iirfilt.rs). Two
realizations: transfer-function form (direct form II via the v-buffer
recurrence, iirfilt.rs:359-371) and a cascade of second-order sections
(iirfilt.rs:377-383). A block runs through ``kernels/iir.py``: the
sequential recurrence (``iir_scan``), or for a ``parallelize()``d filter the
chunked one (``iir_chunked``), each a CUDA kernel on the card and its plain
version on the CPU. Special constructors: Butterworth lowpass, DC blocker,
PLL loop filter, and the 8th-order Pintelon-Schoukens
integrator/differentiator (iirfilt.rs:204-262).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..design import iir as iirdes
from ..errors import ConfigError
from ..kernels.iir import (
    iir_chunked_apply,
    iir_chunked_reference,
    iir_scan_apply,
    iir_scan_reference,
)

__all__ = ["IirFilter"]


def _polar(mag, deg):
    return mag * np.exp(1j * np.pi / 180.0 * deg)


def run_recurrence(x, b, a, scale, v, *, sos: bool, parallel: bool, plain: bool):
    """A block ``x`` [..., T] through the recurrence with state ``v`` (TF
    [..., m], SOS [..., nsos, 2]): the batch flattened to channels, the
    signal in its type (sequential: the state's type; parallel: the
    promotion of signal, state and coefficients, as yagi_tpu's associative
    scan computes it), ``iir_scan`` or ``iir_chunked`` (with ``plain``
    their plain versions on any device). Returns (y, v_new), the state in
    ``v``'s type (its real part for a real state, iirfilt.py:262-265)."""
    tail = 2 if sos else 1
    batch = torch.broadcast_shapes(x.shape[:-1], v.shape[:-tail])
    T = x.shape[-1]
    C = math.prod(batch)
    if parallel:
        sig = torch.promote_types(torch.promote_types(x.dtype, v.dtype), b.dtype)
    else:
        sig = v.dtype
        if x.is_complex() and not sig.is_complex or b.is_complex() and not sig.is_complex:
            raise TypeError(f"a {v.dtype} state cannot carry a {x.dtype} signal through "
                            f"{b.dtype} coefficients; create the filter with a complex dtype")
    xc = torch.broadcast_to(x, batch + (T,)).reshape(C, T).to(sig).contiguous()
    state_shape = batch + v.shape[len(v.shape) - tail:]
    vc = torch.broadcast_to(v, state_shape).reshape((C,) + state_shape[len(batch):])
    vc = vc.to(sig).contiguous()
    if parallel:
        fn = iir_chunked_reference if plain else iir_chunked_apply
    else:
        fn = iir_scan_reference if plain else iir_scan_apply
    y, v_new = fn(xc, b, a, scale, vc, sos=sos)
    if v_new.is_complex() and not v.dtype.is_complex:
        v_new = v_new.real
    return y.reshape(batch + (T,)), v_new.to(v.dtype).reshape(state_shape)


@struct.state
class IirFilter:
    """IIR filter state (iirfilt.rs:25-38).

    ``sos`` realization: B/A are [nsos, 3]; state v is [..., nsos, 2].
    ``norm`` realization: b [nb], a [na]; state v is [..., n-1] window of
    previous direct-form-II values (newest first).
    """

    sos_form: bool = struct.static_field()
    b: torch.Tensor = struct.field()
    a: torch.Tensor = struct.field()
    scale: torch.Tensor = struct.field()
    v: torch.Tensor = struct.field()
    # the chunked block path (iir_chunked): fp32-tolerance-equal to the
    # sequential recurrence, and it fills the card where channels are few
    parallel: bool = struct.static_field(default=False)

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, b, a, batch_shape: tuple = (), dtype=torch.float32,
               device=None) -> "IirFilter":
        """TF form from b/a (iirfilt.rs:66); coefficients normalized by a[0]."""
        device = resolve_device(device)
        b = np.atleast_1d(np.asarray(b))
        a = np.atleast_1d(np.asarray(a))
        if b.size == 0:
            raise ConfigError("numerator length cannot be zero")
        if a.size == 0:
            raise ConfigError("denominator length cannot be zero")
        if a.flat[0] == 0:
            raise ConfigError("a[0] cannot be zero")
        n = max(len(a), len(b))
        cdt = np.complex64 if (np.iscomplexobj(b) or np.iscomplexobj(a)) else np.float32
        bp = np.zeros(n, dtype=cdt)
        ap = np.zeros(n, dtype=cdt)
        bp[: len(b)] = (b / a.flat[0]).astype(cdt)
        ap[: len(a)] = (a / a.flat[0]).astype(cdt)
        return cls(
            sos_form=False,
            b=torch.from_numpy(bp).to(device),
            a=torch.from_numpy(ap).to(device),
            scale=torch.tensor(np.asarray(1.0, dtype=cdt)).to(device),
            v=torch.zeros(tuple(batch_shape) + (n - 1,), dtype=dtype, device=device),
        )

    @classmethod
    def create_sos(cls, B, A, batch_shape: tuple = (), dtype=torch.float32,
                   device=None) -> "IirFilter":
        """SOS cascade from [nsos, 3] matrices (iirfilt.rs:110)."""
        device = resolve_device(device)
        B = np.asarray(B, dtype=np.float64).reshape(-1, 3)
        A = np.asarray(A, dtype=np.float64).reshape(-1, 3)
        if len(B) == 0 or len(B) != len(A):
            raise ConfigError("filter must have at least one 2nd-order section")
        a0 = A[:, :1]
        B = B / a0
        A = A / a0
        return cls(
            sos_form=True,
            b=torch.from_numpy(B.astype(np.float32)).to(device),
            a=torch.from_numpy(A.astype(np.float32)).to(device),
            scale=torch.tensor(1.0, dtype=torch.float32, device=device),
            v=torch.zeros(tuple(batch_shape) + (len(B), 2), dtype=dtype, device=device),
        )

    @classmethod
    def create_prototype(
        cls,
        ftype: iirdes.IirFilterShape,
        btype: iirdes.IirBandType,
        fmt: iirdes.IirFormat,
        order: int,
        fc: float,
        f0: float = 0.0,
        ap: float = 0.1,
        as_: float = 60.0,
        **kw,
    ) -> "IirFilter":
        """Design + realize (iirfilt.rs:148-184)."""
        b, a = iirdes.iir_design(ftype, btype, fmt, order, fc, f0, ap, as_)
        if fmt == iirdes.IirFormat.SECOND_ORDER_SECTIONS:
            return cls.create_sos(b, a, **kw)
        return cls.create(b, a, **kw)

    @classmethod
    def create_lowpass(cls, order: int, fc: float, **kw) -> "IirFilter":
        """Butterworth lowpass in SOS form (iirfilt.rs:189)."""
        return cls.create_prototype(
            iirdes.IirFilterShape.BUTTER,
            iirdes.IirBandType.LOWPASS,
            iirdes.IirFormat.SECOND_ORDER_SECTIONS,
            order,
            fc,
            0.0,
            0.1,
            60.0,
            **kw,
        )

    @classmethod
    def create_dc_blocker(cls, alpha: float, **kw) -> "IirFilter":
        """H(z) = (1-z⁻¹)/(1-(1-α)z⁻¹), scaled √(1-α) (iirfilt.rs:290)."""
        if alpha <= 0.0:
            raise ConfigError("DC-blocking filter bandwidth must be greater than zero")
        f = cls.create([1.0, -1.0], [1.0, -1.0 + alpha], **kw)
        return f.set_scale(float(np.sqrt(1.0 - alpha)))

    @classmethod
    def create_pll(cls, w: float, zeta: float, k: float, **kw) -> "IirFilter":
        """PLL loop filter as one SOS (iirfilt.rs:307)."""
        if w <= 0.0 or w >= 1.0:
            raise ConfigError("PLL bandwidth must be in (0,1)")
        if zeta <= 0.0 or zeta >= 1.0:
            raise ConfigError("PLL damping factor must be in (0,1)")
        if k <= 0.0:
            raise ConfigError("PLL loop gain must be greater than zero")
        b, a = iirdes.iir_design_pll_active_lag(w, zeta, k)
        return cls.create_sos(b.reshape(1, 3), a.reshape(1, 3), **kw)

    @classmethod
    def create_integrator(cls, **kw) -> "IirFilter":
        """8th-order integrator, [Pintelon:1990] Table II (iirfilt.rs:204)."""
        zdi = np.array(
            [
                -1.175839,
                _polar(3.371020, -125.1125),
                _polar(3.371020, 125.1125),
                _polar(4.549710, -80.96404),
                _polar(4.549710, 80.96404),
                _polar(5.223966, -40.09347),
                _polar(5.223966, 40.09347),
                5.443743,
            ]
        )
        pdi = np.array(
            [
                -0.5805235,
                _polar(0.2332021, -114.0968),
                _polar(0.2332021, 114.0968),
                _polar(0.1814755, -66.33969),
                _polar(0.1814755, 66.33969),
                _polar(0.1641457, -21.89539),
                _polar(0.1641457, 21.89539),
                1.0,
            ]
        )
        kdi = -1.89213380759321e-05 / 0.9695401191711425781
        B, A = iirdes.iir_design_d2sos(zdi, pdi, kdi)
        return cls.create_sos(B, A, **kw)

    @classmethod
    def create_differentiator(cls, **kw) -> "IirFilter":
        """8th-order differentiator, [Pintelon:1990] Table IV (iirfilt.rs:234)."""
        zdd = np.array(
            [
                -1.702575,
                _polar(5.877385, -221.4063),
                _polar(5.877385, 221.4063),
                _polar(4.197421, -144.5972),
                _polar(4.197421, 144.5972),
                _polar(5.350284, -66.88802),
                _polar(5.350284, 66.88802),
                1.0,
            ]
        )
        pdd = np.array(
            [
                -0.8476936,
                _polar(0.2990781, -125.5188),
                _polar(0.2990781, 125.5188),
                _polar(0.2232427, -81.52326),
                _polar(0.2232427, 81.52326),
                _polar(0.1958670, -40.51510),
                _polar(0.1958670, 40.51510),
                0.1886088,
            ]
        )
        kdd = 2.09049284907492e-05 / 1.033477783203125000
        B, A = iirdes.iir_design_d2sos(zdd, pdd, kdd)
        return cls.create_sos(B, A, **kw)

    # ------------------------------------------------------------- streaming
    @property
    def nsos(self) -> int:
        return self.b.shape[0] if self.sos_form else 0

    def get_length(self) -> int:
        """Filter length, order+1 (iirfilt.rs:409)."""
        return 2 * self.nsos if self.sos_form else self.b.shape[0]

    def reset(self) -> "IirFilter":
        return self.replace(v=torch.zeros_like(self.v))

    def parallelize(self) -> "IirFilter":
        """Switch block processing to the chunked recurrence (``iir_chunked``).

        Same recurrence, different summation order: outputs match the
        sequential recurrence to fp32 tolerance, and the state carry keeps
        block-split invariance. Keep the default sequential path when
        bit-compatibility with per-sample execution matters.
        """
        return self.replace(parallel=True)

    def execute_block(self, x) -> tuple[torch.Tensor, "IirFilter"]:
        """Block execute (iirfilt.rs:396): x [..., T] → (y [..., T], state)."""
        x = torch.as_tensor(x, device=self.v.device)
        return self._run(x, plain=False)

    def _run(self, x, plain: bool):
        """The block through the kernel wrappers, or with ``plain`` through
        their plain versions on any device (a chain's oracle)."""
        y, v = run_recurrence(x, self.b, self.a, self.scale, self.v, sos=self.sos_form,
                              parallel=self.parallel, plain=plain)
        return y, self.replace(v=v)

    __call__ = execute_block

    def execute(self, x):
        """Single-sample parity (iirfilt.rs:388)."""
        x = torch.as_tensor(x, device=self.v.device)
        y, q = self.execute_block(x[..., None])
        return y[..., 0], q

    def set_scale(self, scale) -> "IirFilter":
        return self.replace(scale=torch.tensor(scale, dtype=self.scale.dtype,
                                               device=self.scale.device))

    def get_scale(self):
        return self.scale

    # ------------------------------------------------------------- analysis
    def freqresponse(self, fc: float) -> complex:
        """Frequency response at fc (iirfilt.rs:413ff)."""
        scale = complex(self.scale.cpu().numpy())
        if self.sos_form:
            B = self.b.cpu().numpy()
            A = self.a.cpu().numpy()
            h = scale
            w = np.exp(-2j * np.pi * fc * np.arange(3))
            for s in range(len(B)):
                h *= np.sum(B[s] * w) / np.sum(A[s] * w)
            return h
        b = self.b.cpu().numpy()
        a = self.a.cpu().numpy()
        w = np.exp(-2j * np.pi * fc * np.arange(len(b)))
        return scale * complex(np.sum(b * w) / np.sum(a * w))

    def groupdelay(self, fc: float) -> float:
        """Group delay (iirfilt.rs:459-478)."""
        B = self.b.cpu().numpy()
        A = self.a.cpu().numpy()
        if self.sos_form:
            return float(sum(iirdes.iir_group_delay(B[s], A[s], fc) for s in range(len(B))))
        return iirdes.iir_group_delay(B.real, A.real, fc)
