"""A 16-QAM signal at 2 samples a symbol through ``tests/test_qamrx.py``'s
channel (``chip_smoke.py::qam_signal``: gain 0.5, an echo 0.1·e^{j1.1} at 3
samples, phase 0.3, complex noise 0.002 per part), made periodic over a
cycle of ``cycle_samples`` samples so that the cycled stream has no seam:
the symbols, the noise, the RRCOS pulse (k 2, m 7, β 0.3) and the echo are
circular over the cycle, and the carrier offset is one whole turn a cycle
(2π/65,536 ≈ 9.59e-5 rad a sample at 65,536, the nearest such value to the
test's 1e-4). Every channel has its own symbols and noise. The cycle is cut
into blocks of ``block`` samples."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import qam_rx as ref

GAIN, PHASE, NOISE = 0.5, 0.3, 0.002
ECHO, ECHO_DELAY = 0.1 * complex(math.cos(1.1), math.sin(1.1)), 3


def periodic(syms: torch.Tensor, noise: torch.Tensor, table: torch.Tensor,
             pulse: np.ndarray) -> torch.Tensor:
    """The signal over one cycle of n = 2·syms.shape[1] samples from the
    symbols ``syms`` [C, n/2] (indices into ``table``) and the unit complex
    noise ``noise`` [C, n], every filter circular over the cycle."""
    c, n = noise.shape
    up = torch.zeros((c, n), dtype=torch.complex64, device=noise.device)
    up[:, ::2] = table[syms]
    sig = torch.zeros_like(up)
    for j, hj in enumerate(pulse):  # causal FIR over the zero-stuffed symbols, circular
        sig.add_(torch.roll(up, j, dims=1), alpha=float(hj))
    del up
    sig.add_(ECHO * torch.roll(sig, ECHO_DELAY, dims=1))
    t = torch.arange(n, dtype=torch.float64, device=noise.device)
    rot = torch.polar(torch.ones_like(t), PHASE + 2.0 * math.pi / n * t).to(torch.complex64)
    sig.mul_(GAIN * rot)
    return sig.add_(NOISE * noise)


def make(cfg: dict, wl: dict, seed: int, device) -> torch.Tensor:
    c, n, t = cfg["channels"], wl["cycle_samples"], wl["block"]
    if n % t or n % 2:
        raise ValueError("the cycle must hold whole blocks and whole symbols")
    gen = torch.Generator(device=device).manual_seed(seed)
    table = ref.constellation(cfg["scheme"], device)
    syms = torch.randint(0, table.shape[0], (c, n // 2), generator=gen, device=device)
    noise = torch.view_as_complex(torch.randn((c, n, 2), generator=gen, device=device))
    pulse = ref.rrcos(cfg["k"], cfg["m"], cfg["beta"])
    x = periodic(syms, noise, table, pulse)
    del noise, syms
    return x.reshape(c, n // t, t).transpose(0, 1).contiguous()
