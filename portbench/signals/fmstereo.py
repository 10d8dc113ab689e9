"""FM stereo broadcasts: ``channels`` stations, each a 200 kHz channel at
baseband carrying an FM-modulated ITU-R BS.450 multiplex, made on the device
from the seed: ``cycle_blocks`` blocks of ``channels`` × ``block`` complex64
samples, [cycle_blocks, channels, block].

Station c's multiplex at sample n of the N-sample cycle (N = cycle_blocks ·
block) is

  m[n] = s·(0.9·[(L + R)/2 + (L − R)/2 · cos 2θ] + 0.1·cos θ)

with θ = 2π·P·n/N + ψ the 19 kHz pilot (P the whole number of cycles a cycle
nearest f_pilot·N), and L, R tones of their own, cos(2π·k·n/N + φ) with k
whole cycles a cycle in 100 Hz - 15 kHz of the 200 kHz channel: every term
is a whole number of cycles over the cycle, so m sums to zero over it. The
scale s puts the station's peak deviation at 75 kHz: kf·max|m| = 0.375
cycles a sample. The carrier is exp(j·(φ0 + 2π·kf·Σ_{k≤n} m[k])), with a
carrier phase φ0 a station, so the stream wraps round the cycle without a
seam; complex AWGN ``SNR_DB`` below the carrier's unit power is added.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SNR_DB = 30.0  # the carrier's power over the noise's
TONE_BAND = (100.0 / 200e3, 15e3 / 200e3)  # cycles a sample: 100 Hz - 15 kHz at 200 kHz
AUDIO, PILOT = 0.9, 0.1  # the multiplex's shares: the audio and the 19 kHz pilot
PEAK_DEVIATION = 0.375  # kf·max|m|, cycles a sample: 75 kHz of a 200 kHz channel


def cycle_samples(wl: dict) -> int:
    return wl["cycle_blocks"] * wl["block"]


def params(cfg: dict, wl: dict, seed: int) -> dict:
    """From the seed: each station's L and R tones (``cycles`` [C, 2], whole
    cycles a cycle, and ``phase`` [C, 2]), its pilot phase ψ [C] and carrier
    phase φ0 [C]; and the pilot's whole cycles a cycle, ``pilot_cycles``."""
    c, n = cfg["channels"], cycle_samples(wl)
    rng = np.random.default_rng(seed)
    lo = max(1, math.ceil(TONE_BAND[0] * n))
    hi = max(lo, math.floor(TONE_BAND[1] * n))
    return {"cycles": rng.integers(lo, hi + 1, (c, 2)),
            "phase": rng.uniform(0.0, 2.0 * math.pi, (c, 2)),
            "pilot_phase": rng.uniform(0.0, 2.0 * math.pi, c),
            "carrier_phase": rng.uniform(0.0, 2.0 * math.pi, c),
            "pilot_cycles": round(cfg["f_pilot"] * n)}


def _tone(cycles, phase, t: torch.Tensor, n: int) -> torch.Tensor:
    """cos(2π·k·t/N + φ) [C, len(t)] with k·t taken mod N exactly in integers."""
    k = torch.as_tensor(cycles, dtype=torch.int64, device=t.device)
    ph = torch.as_tensor(phase, dtype=torch.float64, device=t.device)
    turns = torch.remainder(k[:, None] * t[None, :], n).to(torch.float64)
    return torch.cos(turns * (2.0 * math.pi / n) + ph[:, None])


def multiplex(cfg: dict, wl: dict, prm: dict, t0: int, count: int, device) -> torch.Tensor:
    """The unscaled multiplex 0.9·[(L + R)/2 + (L − R)/2·cos 2θ] + 0.1·cos θ at
    samples t0 … t0 + count − 1 of the cycle, float64 [C, count]."""
    n = cycle_samples(wl)
    t = torch.arange(t0, t0 + count, dtype=torch.int64, device=device)
    left = _tone(prm["cycles"][:, 0], prm["phase"][:, 0], t, n)
    right = _tone(prm["cycles"][:, 1], prm["phase"][:, 1], t, n)
    c = cfg["channels"]
    pilot = np.full(c, prm["pilot_cycles"])
    cos_t = _tone(pilot, prm["pilot_phase"], t, n)
    cos_2t = _tone(2 * pilot, 2.0 * prm["pilot_phase"], t, n)
    return AUDIO * (0.5 * (left + right) + 0.5 * (left - right) * cos_2t) + PILOT * cos_t


def scale(cfg: dict, wl: dict, prm: dict, device) -> torch.Tensor:
    """s [C] float64: kf·s·max|m| = ``PEAK_DEVIATION`` over the cycle."""
    peak = torch.zeros(cfg["channels"], dtype=torch.float64, device=device)
    for b in range(wl["cycle_blocks"]):
        m = multiplex(cfg, wl, prm, b * wl["block"], wl["block"], device)
        peak = torch.maximum(peak, m.abs().amax(dim=1))
    return PEAK_DEVIATION / (cfg["kf"] * peak)


def phases(cfg: dict, wl: dict, prm: dict, device):
    """The carrier's phase φ0 + 2π·kf·Σ_{k≤n} m[k] block by block, float64
    [C, block] each, kept in [0, 2π) between blocks."""
    s = scale(cfg, wl, prm, device)
    phi = torch.as_tensor(prm["carrier_phase"], dtype=torch.float64, device=device)
    for b in range(wl["cycle_blocks"]):
        m = s[:, None] * multiplex(cfg, wl, prm, b * wl["block"], wl["block"], device)
        ph = phi[:, None] + torch.cumsum((2.0 * math.pi * cfg["kf"]) * m, dim=1)
        phi = torch.remainder(ph[:, -1], 2.0 * math.pi)
        yield ph


def make(cfg: dict, wl: dict, seed: int, device) -> torch.Tensor:
    prm = params(cfg, wl, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    sigma = 10.0 ** (-SNR_DB / 20.0) / math.sqrt(2.0)  # per real component, at unit carrier power
    c, t = cfg["channels"], wl["block"]
    out = torch.empty((wl["cycle_blocks"], c, t), dtype=torch.complex64, device=device)
    for b, ph in enumerate(phases(cfg, wl, prm, device)):
        noise = torch.randn((2, c, t), generator=gen, dtype=torch.float32, device=device)
        out[b] = torch.complex(torch.cos(ph).to(torch.float32) + sigma * noise[0],
                               torch.sin(ph).to(torch.float32) + sigma * noise[1])
    return out
