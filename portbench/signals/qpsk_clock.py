"""QPSK carriers at a clock offset: every channel an RRC-shaped (β of the
configuration) QPSK stream at ``cycle_samples`` / ``cycle_symbols`` samples a
symbol (65,536 / 31,716 = 2.066339 in the cell, +19 ppm against the
resampler's nominal 2.0663), made on the device from the seed.

Each channel sends ``cycle_symbols`` QPSK symbols, drawn from the seed and
repeated every ``cycle_samples``-sample cycle, with its own timing offset
(a fraction of a symbol) and carrier phase. The pulse is circular over the
cycle, so the cycled stream has no seam: the signal is made in the frequency
domain, the symbols' DFT times the RRC pulse's spectrum (band-limited to
(1 + β)/2 cycles a symbol, below the sample rate's half, so the samples are
exact and not aliased) times the timing offset's phase ramp, one inverse DFT
a channel. Its power is 1. Complex AWGN at Es/N0 ``ES_N0_DB`` (Es = the
samples a symbol at unit power) is added. The cycle is cut into blocks of
``block`` samples, [cycle_samples / block, C, block] complex64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ES_N0_DB = 20.0
CHUNK = 64  # channels made at a time (complex128 spectra of the whole cycle)


def table() -> np.ndarray:
    """The QPSK points e^{jπ/4}·j^d, d = 0 … 3, complex128."""
    return np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4)))


def params(cfg: dict, wl: dict, seed: int) -> dict:
    """From the seed: ``symbols`` [C, K] int8 (indices into :func:`table`),
    each channel's timing offset ``tau`` [C] in symbols (in [0, 1)) and
    carrier phase ``phase`` [C] in radians."""
    c, k = cfg["channels"], wl["cycle_symbols"]
    rng = np.random.default_rng(seed)
    return {"symbols": rng.integers(0, 4, (c, k), dtype=np.int8),
            "tau": rng.uniform(0.0, 1.0, c), "phase": rng.uniform(0.0, 2 * math.pi, c)}


def rrc_spectrum(nu: np.ndarray, beta: float) -> np.ndarray:
    """The RRC pulse's spectrum at ν cycles a symbol, unit energy: 1 to
    (1 − β)/2, a cosine roll-off to 0 at (1 + β)/2."""
    a = np.abs(nu)
    lo, hi = (1 - beta) / 2, (1 + beta) / 2
    roll = np.cos(np.pi / (2 * beta) * (np.clip(a, lo, hi) - lo))
    return np.where(a <= lo, 1.0, np.where(a <= hi, roll, 0.0))


def clean(cfg: dict, wl: dict, prm: dict, device, rows: slice = slice(None)) -> torch.Tensor:
    """The noiseless cycle of the channels ``rows``, complex128 [c, N]."""
    n, k = wl["cycle_samples"], wl["cycle_symbols"]
    sps = n / k
    q = np.fft.fftfreq(n, 1.0 / n).astype(np.int64)  # 0 … N/2 − 1, −N/2 … −1
    shape = torch.from_numpy(sps * rrc_spectrum(q * sps / n, cfg["beta"])).to(device)
    idx = torch.from_numpy(q % k).to(device)
    a = torch.from_numpy(table()[prm["symbols"][rows]]
                         * np.exp(1j * prm["phase"][rows])[:, None]).to(device)
    delay = torch.from_numpy(prm["tau"][rows] * sps).to(device)  # samples
    angle = torch.outer(delay, torch.from_numpy(q).to(device, torch.float64)) * (-2 * math.pi / n)
    spec = torch.fft.fft(a, dim=1)[:, idx] * shape * torch.polar(torch.ones_like(angle), angle)
    return torch.fft.ifft(spec, dim=1)


def make(cfg: dict, wl: dict, seed: int, device) -> torch.Tensor:
    c, n, t = cfg["channels"], wl["cycle_samples"], wl["block"]
    if n % t:
        raise ValueError("the cycle must hold whole blocks")
    prm = params(cfg, wl, seed)
    sigma = math.sqrt(n / wl["cycle_symbols"] * 10.0 ** (-ES_N0_DB / 10.0) / 2.0)  # per part
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n // t, c, t), dtype=torch.complex64, device=device)
    for c0 in range(0, c, CHUNK):
        rows = slice(c0, min(c, c0 + CHUNK))
        x = clean(cfg, wl, prm, device, rows).to(torch.complex64)
        noise = torch.randn((x.shape[0], n, 2), generator=gen, device=device)
        x += sigma * torch.view_as_complex(noise)
        out[:, rows] = x.reshape(-1, n // t, t).transpose(0, 1)
    return out
