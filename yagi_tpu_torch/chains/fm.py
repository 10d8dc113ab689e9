"""FM broadcast receiver chain: mono and pilot-tone stereo decoding.

Port of :mod:`yagi_tpu.chains.fm`: BASELINE config[2] ("freqdem +
de-emphasis IIR + pilot-tone stereo separation"):

  IQ → Freqdem → composite m(t)
    mono:   lowpass(m)                                  (L+R)/2
    pilot:  complex bandpass at f_p → analytic e^{jθ}
    stereo: 2·Re[lowpass(m · e^{-j2θ})]                 (L-R)/2
    L, R  = mono ± stereo, then de-emphasis IIR

All frequencies are normalized to the composite sample rate (broadcast FM:
f_p = 19 kHz / fs). The pilot's analytic signal comes from a complex-tap FIR
(kaiser lowpass mixed to +f_p), and the 38 kHz subcarrier is its normalized
square. The four FIRs are banded matmuls (``filter/_conv.py``); the two
de-emphasis IIRs run the ``iir_chunked`` kernel, once each per block.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..design import fir_design_kaiser
from ..filter import FirFilter, IirFilter
from ..modem import Freqdem

__all__ = ["FmStereoRx"]


def _complex_bandpass(n: int, fc_width: float, f0: float) -> np.ndarray:
    """Complex-tap bandpass: kaiser lowpass of half-width fc mixed to +f0."""
    h = fir_design_kaiser(n, fc_width, 60.0, 0.0) * (2.0 * fc_width)
    t = np.arange(n) - (n - 1) / 2.0
    return (h * np.exp(2j * np.pi * f0 * t)).astype(np.complex64)


@struct.state
class FmStereoRx:
    """FM stereo receiver state."""

    f_pilot: float = struct.static_field()
    demod: Freqdem = struct.field()
    align: FirFilter = struct.field()  # pure delay matching pilot_bp's group delay
    mono_lp: FirFilter = struct.field()  # audio lowpass for L+R
    diff_lp: FirFilter = struct.field()  # complex lowpass for (L-R) recovery
    pilot_bp: FirFilter = struct.field()  # complex bandpass at f_pilot
    deemph_l: IirFilter = struct.field()
    deemph_r: IirFilter = struct.field()

    @classmethod
    def create(
        cls,
        kf: float = 0.5,
        f_pilot: float = 0.095,  # 19 kHz at fs = 200 kHz
        f_audio: float = 0.075,  # 15 kHz audio bandwidth
        deemph_alpha: float = 0.05,
        n_taps: int = 129,
        batch_shape: tuple = (),
        device=None,
    ) -> "FmStereoRx":
        device = resolve_device(device)
        demod = Freqdem.create(kf, batch_shape=batch_shape, device=device)
        h_audio = fir_design_kaiser(n_taps, f_audio, 60.0, 0.0) * (2 * f_audio)
        mono_lp = FirFilter.create(h_audio.astype(np.float32), batch_shape=batch_shape,
                                   dtype=torch.float32, device=device)
        diff_lp = FirFilter.create(h_audio.astype(np.float32), batch_shape=batch_shape,
                                   dtype=torch.complex64, device=device)
        pilot_bp = FirFilter.create(_complex_bandpass(n_taps, 0.008, f_pilot),
                                    batch_shape=batch_shape, dtype=torch.complex64,
                                    device=device)
        # delay-match the composite to the pilot filter's group delay so the
        # regenerated 38 kHz subcarrier is phase-aligned with the composite
        h_delay = np.zeros(n_taps, dtype=np.float32)
        h_delay[(n_taps - 1) // 2] = 1.0
        align = FirFilter.create(h_delay, batch_shape=batch_shape, dtype=torch.float32,
                                 device=device)

        # single-pole de-emphasis: H(z) = α/(1-(1-α)z⁻¹), on the chunked
        # recurrence (iir_chunked)
        def mk_deemph():
            return IirFilter.create([deemph_alpha], [1.0, -(1.0 - deemph_alpha)],
                                    batch_shape=batch_shape, dtype=torch.float32,
                                    device=device).parallelize()

        return cls(
            f_pilot=float(f_pilot),
            demod=demod,
            align=align,
            mono_lp=mono_lp,
            diff_lp=diff_lp,
            pilot_bp=pilot_bp,
            deemph_l=mk_deemph(),
            deemph_r=mk_deemph(),
        )

    def step(self, iq) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, "FmStereoRx"]:
        """Decode one IQ block [..., T] → (left, right, pilot_level, new state)."""
        iq = torch.as_tensor(iq, device=self.demod.r_prime.device)
        return self._step(iq, plain=False)

    __call__ = step

    def _step(self, iq, plain: bool):
        """:meth:`step`, the de-emphasis through ``iir_chunked``, or with
        ``plain`` through its plain version on any device (the oracle)."""
        m, demod = self.demod.demodulate(iq)

        # analytic pilot (delay D) and delay-matched composite
        z, pilot_bp = self.pilot_bp.execute_block(m.to(torch.complex64))
        m_d, align = self.align.execute_block(m)
        mag = z.abs()
        unit = z / torch.clamp(mag, min=1e-9)
        carrier2 = unit * unit  # e^{+j2θ}, phase-exact 38 kHz subcarrier

        mono, mono_lp = self.mono_lp.execute_block(m_d)
        d, diff_lp = self.diff_lp.execute_block(m_d.to(torch.complex64) * carrier2.conj())
        stereo = 2.0 * d.real

        left, deemph_l = self.deemph_l._run(mono + stereo, plain)
        right, deemph_r = self.deemph_r._run(mono - stereo, plain)
        pilot_level = mag.mean(dim=-1) * 2.0

        return left, right, pilot_level, self.replace(
            demod=demod,
            align=align,
            mono_lp=mono_lp,
            diff_lp=diff_lp,
            pilot_bp=pilot_bp,
            deemph_l=deemph_l,
            deemph_r=deemph_r,
        )
