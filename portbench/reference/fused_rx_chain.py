"""Plain reference of the wideband receive chain (``rxchain16``): a 64-tap
Kaiser low-pass FIR (scaled by 2·fc) → a P× polyphase interpolator (liquid's
resamp, npfb branches of 2m taps, on a u32 phase whose step makes branch
δ·npfb/P serve output δ) → a mix-down by an NCO on a u32 phase, in float64
on the device, two stages as written (not the program's combined filters).

Every block's reference is worked out from the input cycle alone: its
history is the last samples of the block before it in the stream, its phase
θ_b = b·T·P·dθ mod 2^32. Compared: the output, as its largest gap over the
block's rms, and the carried state (the 128-sample history planes, the NCO
phase and step) exactly.

The control (``control=True``) runs the same two stages in float32 with each
product's operands rounded to TF32 (10-bit mantissa, to nearest, ties away,
as the tensor cores' conversion), the precision a matmul with TF32 on would
give.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HIST = 128  # the history the program carries, in input samples
U32 = (1 << 32) - 1


def kaiser_beta(as_: float) -> float:
    """Kaiser's β for a stop-band attenuation in dB (liquid kaiser.rs:62)."""
    a = abs(as_)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_lowpass(n: int, fc: float, as_: float) -> np.ndarray:
    """Windowed-sinc low-pass of n taps, cutoff fc, Kaiser window of β(as_)."""
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    return np.sinc(2.0 * fc * t) * np.kaiser(n, kaiser_beta(as_))


def design(cfg: dict) -> dict:
    """The FIR taps (scaled), the interpolator's branches [P, 2m] (the one
    serving each output phase), P, and the NCO step dθ."""
    npfb, m, p = cfg["npfb"], cfg["m"], int(cfg["rate"])
    h = kaiser_lowpass(cfg["n_taps"], cfg["fc"], cfg["as"]) * (2.0 * cfg["fc"])
    n = 2 * m * npfb + 1
    hf = kaiser_lowpass(n, 0.25 / npfb, cfg["as"])
    hf = hf * (npfb / hf.sum())  # unit gain per branch
    bank = hf[: n - 1].reshape(2 * m, npfb).T  # bank[i, l] = hf[i + l·npfb]
    return {"h": h, "branches": bank[[d * npfb // p for d in range(p)]], "p": p,
            "d_theta": phase_step(cfg["mix_freq"])}


def phase_step(freq: float) -> int:
    """A frequency in rad/sample as a u32 phase step, liquid's float32 rule
    (osc.rs:191-200: floored fmod by 2π, ×2^32/2π, truncated, saturated)."""
    f, two_pi = np.float32(freq), np.float32(2.0 * np.pi)
    r = np.float32(np.fmod(f, two_pi))
    if r < 0:
        r = np.float32(r + two_pi)
    u = np.float32(np.float32(r / two_pi) * np.float32(4294967296.0))
    return int(min(max(int(u), 0), U32))


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32: 10 mantissa bits,
    to nearest, ties away from zero."""
    if t.is_complex():
        return torch.complex(_tf32(t.real.contiguous()), _tf32(t.imag.contiguous()))
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def chain(x: torch.Tensor, hist: torch.Tensor, theta0: int, des: dict,
          control: bool = False) -> torch.Tensor:
    """One block x [C, T] after the history hist [C, HIST] → y [C, T·P]."""
    dt = torch.complex64 if control else torch.complex128
    rnd = _tf32 if control else (lambda v: v)
    h, br, p = des["h"], des["branches"], des["p"]
    c, t = x.shape
    n_h, n_b = len(h), br.shape[1]
    xe = rnd(torch.cat([hist, x], dim=1).to(dt))
    h_t = rnd(torch.as_tensor(h, dtype=torch.float64 if not control else torch.float32,
                              device=x.device))
    # the FIR's output at stream positions −(n_b − 1) … T − 1
    lead = n_b - 1
    u = torch.zeros((c, t + lead), dtype=dt, device=x.device)
    for i in range(n_h):
        s = HIST - lead - i
        u += h_t[i] * xe[:, s: s + t + lead]
    u = rnd(u)
    y = torch.empty((c, t, p), dtype=dt, device=x.device)
    br_t = rnd(torch.as_tensor(br, dtype=h_t.dtype, device=x.device))
    for d in range(p):
        acc = torch.zeros((c, t), dtype=dt, device=x.device)
        for j in range(n_b):
            acc += br_t[d, j] * u[:, lead - j: lead - j + t]
        y[:, :, d] = acc
    y = y.reshape(c, t * p)
    m = torch.arange(t * p, dtype=torch.int64, device=x.device)
    theta = (theta0 + m * des["d_theta"]) & U32
    ang = theta.to(torch.float64) * (2.0 * math.pi / 4294967296.0)
    rot = torch.polar(torch.ones_like(ang), -ang).to(dt)
    return y * rot


def check(cfg, wl, blocks, start, kept, device, control: bool = False):
    des = design(cfg)
    t, p = wl["block"], des["p"]
    step = t * p * des["d_theta"]
    per_block = []
    for item in [start] + list(kept):
        b = item.index
        x = blocks[b % len(blocks)]
        hist = (blocks[(b - 1) % len(blocks)][:, -HIST:] if b > 0
                else torch.zeros((x.shape[0], HIST), dtype=x.dtype, device=x.device))
        theta0 = (b * step) & U32
        want = chain(x, hist, theta0, des)
        got = chain(x, hist, theta0, des, control=True) if control else item.out
        rms = want.abs().square().mean().sqrt()
        gap = ((got.to(want.dtype) - want).abs().max() / rms).item()
        if control:  # the control carries the state exactly
            errors = 0
        else:
            st = item.after
            errors = int((st["hist_r"] != x.real[:, -HIST:]).sum().item()
                         + (st["hist_i"] != x.imag[:, -HIST:]).sum().item()
                         + (int(st["theta"]) != ((theta0 + step) & U32))
                         + (int(st["d_theta"]) != des["d_theta"]))
        per_block.append({"out_gap": gap, "state_errors": errors})
    return per_block, {"compared_blocks": len(per_block)}
