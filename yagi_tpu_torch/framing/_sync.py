"""The burst synchronizers' block maths on the device (QDSync, FrameSync64).

yagi_tpu computes these steps in numpy, which promotes to complex128
(``qdsync.py:80-131``, ``frame64.py:138-195``); the port computes them in
complex128 on the synchronizer's device, from the detection's host values:
derotate and scale the buffer, advance it by the fractional delay with an
FFT phase ramp, take the full matched-filter convolution at the symbol
instants only (the rest of it is never read), and fit a weighted linear
phase to the known preamble: over the raw angles (frame64, QDSync, DSSS),
or over the unwrapped angles of the preamble and any other known symbols
(flexframe's ``_symbols``, ``flexframe.py:158-198``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def as_samples(x, device) -> torch.Tensor:
    """``x`` (a tensor, or anything numpy takes) as a flat complex64 tensor
    on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.complex64))
    return x.to(device=device, dtype=torch.complex64).reshape(-1)


def derotate(x: torch.Tensor, det: dict) -> tuple[torch.Tensor, int]:
    """x·e^{−j(dphi·(n − tau) + phi)}/gamma, advanced by frac(tau): (y
    complex128, floor(tau)).

    The detection's phase is the carrier's at the burst's start (the
    correlation peak), so the ramp is referenced there. yagi_tpu references
    it at the buffer's start (e^{−j(dphi·n + phi)}), which leaves a constant
    phase of about −dphi·tau on the symbols; where that sits near ±π, the
    preamble's angles wrap and the phase fit fails (ROADMAP queue 3). Away
    from ±π the two differ by that constant phase only, which the fit's
    intercept removes, so the symbols agree.
    """
    n = torch.arange(x.shape[0], dtype=torch.float64, device=x.device) - det["tau"]
    y = x.to(torch.complex128) * torch.polar(torch.ones_like(n), -(det["dphi"] * n + det["phi"]))
    y = y / max(det["gamma"], 1e-9)
    i0 = math.floor(det["tau"])
    frac = det["tau"] - i0
    if frac > 1e-6:  # sub-sample advance via FFT phase ramp
        f = torch.fft.fftfreq(y.shape[0], dtype=torch.float64, device=x.device)
        y = torch.fft.ifft(torch.fft.fft(y) * torch.polar(torch.ones_like(f), 2 * math.pi * f * frac))
    return y, i0


def matched_symbols(y: torch.Tensor, h: torch.Tensor, i0: int, k: int, nsym: int) -> torch.Tensor:
    """z[i0 + d + k·i], i < nsym, of z = convolve(y, h) (full, d = len(h) − 1),
    as complex64: each a dot of len(h) samples of y (zeros outside it) with
    h reversed. The caller keeps i0 + d + k·(nsym − 1) < len(z)."""
    L = h.shape[0]
    pad = y.new_zeros(L)
    yp = torch.cat([pad, y, pad])  # yp[m + L] = y[m]
    windows = yp[i0 + L:].unfold(0, L, k)[:nsym]  # [nsym, L]: y[i0 + k·i + q]
    return (windows @ h.flip(0).to(torch.complex128)).to(torch.complex64)


def unwrap(theta: torch.Tensor) -> torch.Tensor:
    """numpy's ``unwrap`` along the last axis (period 2π, discont π): each
    step d = diff is replaced by dm = mod(d + π, 2π) − π (π where dm is −π
    and d > 0) where |d| ≥ π, and the corrections accumulate."""
    if theta.shape[-1] < 2:
        return theta.clone()
    d = theta.diff(dim=-1)
    dm = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    dm = torch.where((dm == -math.pi) & (d > 0), torch.full_like(dm, math.pi), dm)
    fix = torch.where(d.abs() < math.pi, torch.zeros_like(d), dm - d)
    return torch.cat([theta[..., :1], theta[..., 1:] + fix.cumsum(-1)], -1)


def phase_fit(syms: torch.Tensor, ref: torch.Tensor, idx: torch.Tensor | None = None,
              unwrapped: bool = False):
    """Weighted least-squares line ang ≈ a + b·i over the known symbols
    ``ref`` at positions ``idx`` (int64 on the device; the first
    len(ref) by default), ang the angles of syms[idx]·conj(ref), unwrapped
    in ``idx``'s order where asked: (a, b, amp) as float64 device tensors,
    amp the implied channel amplitude (W / Σ|ref|²)."""
    if idx is None:
        idx = torch.arange(ref.shape[0], device=syms.device)
    e = syms[idx] * ref.conj()
    w = e.abs().to(torch.float64)
    ang = torch.angle(e).to(torch.float64)
    if unwrapped:
        ang = unwrap(ang)
    i = idx.to(torch.float64)
    W = w.sum()
    Swi, Swa = (w * i).sum(), (w * ang).sum()
    b = ((w * i * ang).sum() * W - Swi * Swa) / ((w * i * i).sum() * W - Swi ** 2).clamp(min=1e-12)
    a = (Swa - b * Swi) / W.clamp(min=1e-12)
    amp = W / ref.abs().square().sum().to(torch.float64).clamp(min=1e-12)
    return a, b, amp


def correct(syms: torch.Tensor, a, b, amp) -> torch.Tensor:
    """syms·e^{−j(a + b·k)}/max(amp, 1e-9), complex128."""
    kk = torch.arange(syms.shape[0], dtype=torch.float64, device=syms.device)
    ph = a + b * kk
    return syms.to(torch.complex128) * torch.polar(torch.ones_like(ph), -ph) / amp.clamp(min=1e-9)


def evm_db(syms: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """10·log10(mean |syms − ref|² / mean |ref|² + 1e-20) over the known
    symbols."""
    err = syms[: ref.shape[0]] - ref
    return 10.0 * torch.log10(err.abs().square().mean() / ref.abs().square().mean().to(
        torch.float64) + 1e-20)
