"""Plain reference of the FM-band channelizer farm (``chz64fm``): liquid's
firpfbch analyzer as written, then freqdem on every channel, in float64 on
the device.

The prototype is designed again: a Kaiser windowed-sinc of 2·M·m + 1 taps,
cutoff 0.5/M, stop-band ``as`` dB, its last tap dropped (liquid's
``firpfbch_create_kaiser``). For analyzer step i the bank runs

  commutator   s_b[i] = x[iM − b]                      (branch b, b = 0 … M − 1)
  branch FIR   u_b[i] = Σ_j h[b + jM] · s_b[i − j]     (p = 2m taps a branch)
  IDFT         y_k[i] = Σ_b u_b[i] · e^{+2πj·bk/M}     (unnormalized)

and the discriminator fm_k[i] = arg(conj(y_k[i − 1])·y_k[i]) / (2π·kf)
(freqdem.rs:35), written out as atan2(pr·ri − pi·rr, pr·rr + pi·ri), with
y_k[−1] the channel's carried last output. This is the textbook form, not
the program's lane-packed tables and FFT.

A block is followed from the program's state before it (its input history
and last outputs, ``drivers/chz_fm.py::view``), in chunks of steps; the
stream's first block starts from zeros, which is checked. Compared, block by
block: the channels (``chan_gap``: largest |y − y_ref| over the block's rms
of y_ref), the discriminator (``fm_gap``: largest |fm − fm_ref| over the rms
of fm_ref, the two taken as angles), the carried last outputs (``state_gap``:
largest gap over the block's channel rms) and the carried history, which is
a copy of the block's last input samples (``state_errors``: elements that
differ).

The control (``control=True``) runs the same steps in float32 with each
product's operands rounded to TF32 (10-bit mantissa, to nearest, ties away,
as the tensor cores' conversion), the precision a matmul with TF32 on would
give.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 1 << 16  # analyzer steps a chunk


def kaiser_beta(as_: float) -> float:
    """Kaiser's β for a stop-band attenuation in dB (liquid kaiser.rs:62)."""
    a = abs(as_)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def prototype(cfg: dict) -> np.ndarray:
    """The analysis prototype h, 2·M·m taps."""
    m_ch = cfg["channels"]
    n = 2 * m_ch * cfg["m"] + 1
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = np.sinc(2.0 * (0.5 / m_ch) * t) * np.kaiser(n, kaiser_beta(cfg["as"]))
    return h[: n - 1]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32: 10 mantissa bits,
    to nearest, ties away from zero."""
    if t.is_complex():
        return torch.complex(_tf32(t.real.contiguous()), _tf32(t.imag.contiguous()))
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def analyzer(xr, xi, hist_r, hist_i, h: np.ndarray, m_ch: int,
             control: bool = False) -> torch.Tensor:
    """One block of planes xr, xi [T·M] after the input history hist_r,
    hist_i [H] (H a multiple of M, at least p·M) → y [T, M]."""
    real = torch.float32 if control else torch.float64
    rnd = _tf32 if control else (lambda v: v)
    p = h.size // m_ch
    e = torch.complex(torch.cat([hist_r, xr]).to(real), torch.cat([hist_i, xi]).to(real))
    rows = rnd(e).reshape(-1, m_ch)  # row r: the M samples from r·M on
    h0 = hist_r.shape[0] // m_ch  # the row of the block's step 0
    t = rows.shape[0] - h0
    # commutator: s[r, b] = x[rM − b], branch 0 the row's first sample, branch b ≥ 1
    # sample M − b of the row before
    s = torch.zeros_like(rows)
    s[:, 0] = rows[:, 0]
    s[1:, 1:] = rows[:-1, 1:].flip(-1)
    # the branches' taps: br[j, b] = h[b + jM]
    br = rnd(torch.as_tensor(h.reshape(p, m_ch), dtype=real, device=xr.device))
    k = np.arange(m_ch)
    w = rnd(torch.as_tensor(np.exp(2j * np.pi * np.outer(k, k) / m_ch),
                            dtype=s.dtype, device=xr.device))
    y = torch.empty((t, m_ch), dtype=s.dtype, device=xr.device)
    for i0 in range(0, t, CHUNK):
        n = min(CHUNK, t - i0)
        u = torch.zeros((n, m_ch), dtype=s.dtype, device=xr.device)
        for j in range(p):
            u += br[j] * s[h0 + i0 - j: h0 + i0 - j + n]
        y[i0: i0 + n] = rnd(u) @ w
    return y


def discriminate(y: torch.Tensor, r_prime: torch.Tensor, kf: float,
                 control: bool = False) -> torch.Tensor:
    """fm [T, M] of the channels y [T, M] after their last outputs r_prime [M]."""
    rnd = _tf32 if control else (lambda v: v)
    r = rnd(y)
    prev = torch.cat([rnd(r_prime.to(y.dtype))[None], r[:-1]])
    pr, pi, rr, ri = prev.real, prev.imag, r.real, r.imag
    return torch.atan2(pr * ri - pi * rr, pr * rr + pi * ri) * (1.0 / (2.0 * math.pi * kf))


def _gap(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    return ((got.to(want.dtype) - want).abs().max() / scale).item()


def _fm_gap(got: torch.Tensor, want: torch.Tensor, kf: float) -> float:
    """Largest gap between two discriminator outputs as angles (±π·scale are
    one point: a phase step at the cut may round to either side), over the
    rms of ``want``."""
    period = 1.0 / kf  # 2π of phase, in fm units
    d = torch.remainder(got.to(want.dtype) - want + 0.5 * period, period) - 0.5 * period
    return (d.abs().max() / want.square().mean().sqrt()).item()


def check(cfg, wl, blocks, start, kept, device, control: bool = False):
    h = prototype(cfg)
    m_ch, kf = cfg["channels"], cfg["kf"]
    per_block = []
    for item in [start] + list(kept):
        x = blocks[item.index % len(blocks)]
        st0 = item.before
        y_ref = analyzer(x[0], x[1], st0["hist_r"], st0["hist_i"], h, m_ch)
        fm_ref = discriminate(y_ref, st0["r_prime"], kf)
        if control:  # the same steps in TF32 in the program's place; it carries the state exactly
            y = analyzer(x[0], x[1], st0["hist_r"], st0["hist_i"], h, m_ch, control=True)
            fm = discriminate(y, st0["r_prime"], kf, control=True)
            last, errors = y[-1], 0
        else:
            yr, yi, fm = item.out
            y, st1 = torch.complex(yr, yi), item.after
            last = st1["r_prime"]
            nh = st1["hist_r"].shape[0]
            errors = int((st1["hist_r"] != x[0][-nh:]).sum().item()
                         + (st1["hist_i"] != x[1][-nh:]).sum().item())
            if item.index == 0:  # the stream starts from zeros
                errors += int(sum((v != 0).sum().item() for v in st0.values()))
        rms = y_ref.abs().square().mean().sqrt()
        per_block.append({
            "chan_gap": _gap(y, y_ref, rms),
            "fm_gap": _fm_gap(fm, fm_ref, kf),
            "state_gap": _gap(last, y_ref[-1], rms),
            "state_errors": errors,
        })
    return per_block, {"compared_blocks": len(per_block)}
