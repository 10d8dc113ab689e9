"""An FM band: one constant-envelope FM carrier at the centre of each of the
``channels`` analysis channels, in complex white noise, made on the device
from the seed: ``cycle_blocks`` blocks of ``channels`` × ``block`` wideband
samples as planar float32 planes, [cycle_blocks, 2, channels·block].

Channel k's carrier sits at k/M cycles a sample (M = ``channels``), the
centre of the analyzer's channel k. Its phase is held for each M-sample step
t, so the wideband stream is, step by step, a 64-point inverse DFT of the
carriers' values A·e^{jφ_k[t]}. Each carrier is FM-modulated at ``kf`` by its
own message: three tones with amplitudes drawn to sum to 1 (peak 1) and
frequencies drawn in 100 Hz - 15 kHz of a 200 kHz channel (cycles a step),
each a whole number of cycles over the cycle of blocks, so the phase steps
Δφ_k[t] = 2π·kf·m_k[t] lie within ±2π·kf = ±0.2π and the stream wraps round
the cycle without a seam (every message sums to zero over it). The noise is
complex AWGN ``SNR_DB`` below one carrier's power, over the whole band. The
total power of the carriers is 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SNR_DB = 30.0  # a carrier's power over the band's noise power
TONES = 3
TONE_BAND = (100.0 / 200e3, 15e3 / 200e3)  # cycles a step: 100 Hz - 15 kHz of a 200 kHz channel


def messages(cfg: dict, wl: dict, seed: int) -> dict:
    """The messages' tones from the seed: ``amp`` [M, 3] (each row sums to
    1), ``cycles`` [M, 3] (whole cycles a cycle of blocks), ``phase`` [M, 3]
    and each carrier's phase at the stream's start, ``phi0`` [M]."""
    m, steps = cfg["channels"], wl["cycle_blocks"] * wl["block"]
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.2, 1.0, (m, TONES))
    lo = max(1, math.ceil(TONE_BAND[0] * steps))
    hi = max(lo, min(math.floor(TONE_BAND[1] * steps), steps // 2 - 1))
    return {"amp": amp / amp.sum(axis=1, keepdims=True),
            "cycles": rng.integers(lo, hi + 1, (m, TONES)),
            "phase": rng.uniform(0.0, 2.0 * math.pi, (m, TONES)),
            "phi0": rng.uniform(0.0, 2.0 * math.pi, m)}


def phase_steps(cfg: dict, wl: dict, tones: dict, t0: int, n: int, device) -> torch.Tensor:
    """Δφ[t, k] = 2π·kf·m_k[t] for steps t0 … t0 + n − 1, float64 [n, M]."""
    steps = wl["cycle_blocks"] * wl["block"]
    t = torch.arange(t0, t0 + n, dtype=torch.float64, device=device)
    cyc = torch.as_tensor(tones["cycles"], dtype=torch.float64, device=device)
    ph = torch.as_tensor(tones["phase"], dtype=torch.float64, device=device)
    amp = torch.as_tensor(tones["amp"], dtype=torch.float64, device=device)
    msg = torch.zeros((n, cyc.shape[0]), dtype=torch.float64, device=device)
    for i in range(TONES):  # whole cycles: 2π·c·t/steps taken mod 2π exactly in integers
        arg = (torch.remainder(t[:, None] * cyc[:, i], steps) * (2.0 * math.pi / steps)
               + ph[:, i])
        msg += amp[:, i] * torch.cos(arg)
    return (2.0 * math.pi * cfg["kf"]) * msg


def make(cfg: dict, wl: dict, seed: int, device) -> torch.Tensor:
    m, t = cfg["channels"], wl["block"]
    tones = messages(cfg, wl, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    a = 1.0 / math.sqrt(m)  # each carrier's amplitude: the carriers' power sums to 1
    sigma = a * 10.0 ** (-SNR_DB / 20.0) / math.sqrt(2.0)  # per real component
    out = torch.empty((wl["cycle_blocks"], 2, m * t), dtype=torch.float32, device=device)
    phi = torch.as_tensor(tones["phi0"], dtype=torch.float64, device=device)
    for b in range(wl["cycle_blocks"]):
        dphi = phase_steps(cfg, wl, tones, b * t, t, device)
        # the phase at step t is φ0 plus the steps before it
        cum = torch.cumsum(dphi, dim=0)
        held = torch.cat([phi[None], phi[None] + cum[:-1]])
        phi = phi + cum[-1]
        x = torch.fft.ifft(torch.polar(torch.full_like(held, a), held), dim=1, norm="forward")
        x = x.reshape(-1).to(torch.complex64)
        out[b, 0] = x.real + sigma * torch.randn(m * t, generator=gen, device=device)
        out[b, 1] = x.imag + sigma * torch.randn(m * t, generator=gen, device=device)
    return out
