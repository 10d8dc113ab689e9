"""Shared block-math carrier recovery helpers for burst synchronizers.

These replace liquid's per-sample carrier PLLs with closed-form block
operations (SURVEY.md §7 design stance): a weighted LSQ linear-phase fit
over known symbols, and chunk-wise decision-directed phase tracking for
long payloads where extrapolating the preamble fit would drift.

Copied from :mod:`yagi_tpu.framing._carrier`. Where it runs: on the host in
numpy, as in yagi_tpu; symbols may be given as tensors (they are read to
the host). :func:`dd_track` takes the port's
:class:`~yagi_tpu_torch.modem.Modem`, whose decisions run on its device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["linear_phase_fit", "dd_track", "mth_power_cfo"]


def _host(x) -> np.ndarray:
    """A tensor's values on the host, or ``np.asarray`` of anything else."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mth_power_cfo(syms, m: int = 4, nfft_factor: int = 8) -> float:
    """Blind M-th power carrier-frequency estimator (Viterbi&Viterbi).

    Raising M-PSK symbols to the M-th power strips the modulation; the
    residual CFO appears as a tone at M*dphi, located by a zero-padded FFT
    argmax with quadratic interpolation. Returns dphi in rad/symbol.
    Valid for |dphi| < pi/M."""
    s = _host(syms).astype(np.complex128)
    mag = np.abs(s) + 1e-20
    v = (s / mag) ** m * mag  # unit-power phase, amplitude-weighted
    nfft = int(2 ** np.ceil(np.log2(max(64, s.size * nfft_factor))))
    V = np.abs(np.fft.fft(v, nfft))
    i0 = int(np.argmax(V))
    ym1, y0, yp1 = V[(i0 - 1) % nfft], V[i0], V[(i0 + 1) % nfft]
    den = ym1 - 2.0 * y0 + yp1
    d = 0.5 * (ym1 - yp1) / den if abs(den) > 1e-12 else 0.0
    bin_f = i0 + float(np.clip(d, -0.5, 0.5))
    if bin_f > nfft / 2:
        bin_f -= nfft
    return float(2.0 * np.pi * bin_f / (nfft * m))


def linear_phase_fit(syms, ref, idx=None):
    """Weighted LSQ fit ang ~ a + b*i over known symbols.

    syms: received symbols at the known positions; ref: expected symbols;
    idx: positions (default 0..n-1). Returns (a, b, amp) where amp is the
    implied channel amplitude."""
    syms = _host(syms)
    ref = _host(ref)
    i = np.arange(syms.size, dtype=np.float64) if idx is None \
        else np.asarray(idx, dtype=np.float64)
    e = syms * np.conj(ref)
    w = np.abs(e)
    ang = np.unwrap(np.angle(e))
    W = np.sum(w)
    den = max(np.sum(w * i * i) * W - np.sum(w * i) ** 2, 1e-12)
    b = (np.sum(w * i * ang) * W - np.sum(w * i) * np.sum(w * ang)) / den
    a = (np.sum(w * ang) - b * np.sum(w * i)) / max(W, 1e-12)
    amp = W / max(np.sum(np.abs(ref) ** 2), 1e-12)
    return float(a), float(b), float(max(amp, 1e-9))


def dd_track(syms, modem, chunk: int = 32):
    """Chunk-wise decision-directed carrier phase tracking.

    Per chunk: demodulate, re-modulate the decisions, remove the average
    phase error; the correction accumulates across chunks so residual CFO
    is tracked through arbitrarily long payloads. Use only with memoryless
    (non-differential) modem schemes."""
    out = np.array(_host(syms), dtype=np.complex64)
    phase = 0.0
    for c0 in range(0, out.size, chunk):
        s = out[c0: c0 + chunk] * np.exp(-1j * phase)
        dsyms, _ = modem.demodulate(s.astype(np.complex64))
        ref, _ = modem.modulate(dsyms)
        e = np.sum(s * np.conj(_host(ref)))
        dph = float(np.angle(e))
        phase += dph
        out[c0: c0 + chunk] = s * np.exp(-1j * dph)
    return out
