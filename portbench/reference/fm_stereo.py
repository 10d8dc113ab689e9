"""Plain reference of the FM stereo decoder farm (``fmstereo512``): liquid's
freqdem, firfilt and iirfilt as written, in float64 on the device, and the
stereo separation of ``chains/fm.py``'s docstring.

The taps are designed again: the audio lowpass is liquid's Kaiser
windowed-sinc (``firdes_kaiser``) of ``n_taps`` taps, cutoff ``f_audio``,
60 dB, scaled by 2·f_audio; the pilot's bandpass the same lowpass at a
half-width of 0.008 (scaled by 0.016) mixed to +f_pilot about its centre;
the delay a unit tap at (n_taps − 1)/2, the bandpass's group delay. For each
station and each sample n of a block:

  freqdem      m[n]   = arg(conj(r[n−1])·r[n]) / (2π·kf), r[−1] the carried last sample
  pilot        z[n]   = Σ_k hp[k]·m[n−k],  u = z/max(|z|, 1e-9),  pilot level 2·mean|z|
  delay        md[n]  = Σ_k hd[k]·m[n−k]
  sum          mono   = Σ_k ha[k]·md[n−k]
  difference   d[n]   = Σ_k ha[k]·(md·conj(u²))[n−k],  stereo = 2·Re d
  de-emphasis  y[n]   = α·x[n] + (1 − α)·y[n−1],  x = mono ± stereo (left, right)

each FIR a direct sum over the carried window (its input's last n_taps − 1
samples before the block), written out tap by tap; each de-emphasis the
first-order recurrence sample by sample from y[−1] = α·v, v the carried
direct-form-II value (iirfilt's state: y = α·w, w[n] = x[n] + (1 − α)·w[n−1]).
This is the textbook form, not the program's banded matmuls or chunked scan.

A block is followed from the program's state before it
(``drivers/fm_stereo.py::view``); the stream's first block starts from zeros,
which is checked. Compared, block by block: the audio (``left_gap``,
``right_gap``: largest |y − y_ref| over the block's rms of y_ref), the pilot
level (``pilot_gap``, over its rms), the carried FIR windows and IIR states
(``state_gap``: each quantity's largest gap over the rms of the stream it
carries) and the carried copies (``state_errors``: elements that differ: the
discriminator's last sample against the block's last input, the pilot's
window against the delay's, which carry the same samples of m).

The control (``control=True``) runs the same steps in float32 with each FIR
product's operands rounded to TF32 (10-bit mantissa, to nearest, ties away,
as the tensor cores' conversion), the precision the banded matmuls would
have with TF32 on; it carries its own state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PILOT_HALF_WIDTH = 0.008  # the pilot bandpass's half-width (chains/fm.py)
MIN_MAG = 1e-9  # the floor of |z| in the pilot's normalisation (chains/fm.py)


def kaiser_beta(as_: float) -> float:
    """Kaiser's β for a stop-band attenuation in dB (liquid kaiser.rs:62)."""
    a = abs(as_)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_lowpass(n: int, fc: float, as_: float = 60.0) -> np.ndarray:
    """liquid's Kaiser windowed-sinc lowpass of n taps, cutoff fc, no offset."""
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    return np.sinc(2.0 * fc * t) * np.kaiser(n, kaiser_beta(as_))


def taps(cfg: dict) -> dict:
    """The four filters' taps, float64 (the pilot's complex128)."""
    n, fa, fp = cfg["n_taps"], cfg["f_audio"], cfg["f_pilot"]
    t = np.arange(n) - (n - 1) / 2.0
    delay = np.zeros(n)
    delay[(n - 1) // 2] = 1.0
    return {"audio": kaiser_lowpass(n, fa) * (2.0 * fa),
            "pilot": kaiser_lowpass(n, PILOT_HALF_WIDTH) * (2.0 * PILOT_HALF_WIDTH)
            * np.exp(2j * np.pi * fp * t),
            "delay": delay}


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32: 10 mantissa bits,
    to nearest, ties away from zero."""
    if t.is_complex():
        return torch.complex(_tf32(t.real.contiguous()), _tf32(t.imag.contiguous()))
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """The precision of a run: float64, or the control's float32 with each
    FIR product's operands rounded to TF32."""

    def __init__(self, control: bool):
        self.control = control
        self.real = torch.float32 if control else torch.float64
        self.cplx = torch.complex64 if control else torch.complex128

    def fir(self, h: np.ndarray, hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y[n] = Σ_k h[k]·x[n−k] over the block x [C, T], x[−1 …] the window
        ``hist`` [C, L] (its last L − 1 samples the ones before the block)."""
        cx = np.iscomplexobj(h) or x.is_complex() or hist.is_complex()
        dt = self.cplx if cx else self.real
        L, T = h.size, x.shape[-1]
        xa = torch.cat([hist[..., 1:].to(dt), x.to(dt)], dim=-1)
        ht = torch.as_tensor(h, device=x.device).to(dt)
        if self.control:
            xa, ht = _tf32(xa), _tf32(ht)
        y = torch.zeros(x.shape, dtype=dt, device=x.device)
        for k in range(L):  # x[n − k] = xa[n + L − 1 − k]
            y += ht[k] * xa[..., L - 1 - k: L - 1 - k + T]
        return y

    def deemph(self, alpha: float, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y[n] = α·x[n] + (1 − α)·y[n−1], y[−1] = α·v, over x [C, T]."""
        ax = alpha * x.to(self.real)
        prev = alpha * v.to(self.real)
        ys = []
        for n in range(x.shape[-1]):
            prev = torch.add(ax[:, n], prev, alpha=1.0 - alpha)
            ys.append(prev)
        return torch.stack(ys, dim=-1)


def decode(cfg: dict, r: torch.Tensor, st: dict, control: bool = False) -> dict:
    """One block r [C, T] from the carried state ``st`` (the driver's view):
    the outputs, and every stream the state carries a window of."""
    ar = Arith(control)
    h = taps(cfg)
    alpha, kf = cfg["deemph_alpha"], cfg["kf"]
    x = r.to(ar.cplx)
    prev = torch.cat([st["r_prime"].to(ar.cplx)[:, None], x[:, :-1]], dim=-1)
    pr, pi, rr, ri = prev.real, prev.imag, x.real, x.imag
    m = torch.atan2(pr * ri - pi * rr, pr * rr + pi * ri) * (1.0 / (2.0 * math.pi * kf))
    z = ar.fir(h["pilot"], st["pilot_w"], m)
    mag = z.abs()
    unit = z / torch.clamp(mag, min=MIN_MAG)
    md = ar.fir(h["delay"], st["align_w"], m)
    mono = ar.fir(h["audio"], st["mono_w"], md)
    dx = md * (unit * unit).conj()
    stereo = 2.0 * ar.fir(h["audio"], st["diff_w"], dx).real
    left = ar.deemph(alpha, st["deemph_l"][:, 0], mono + stereo)
    right = ar.deemph(alpha, st["deemph_r"][:, 0], mono - stereo)
    return {"left": left, "right": right, "pilot": 2.0 * mag.mean(dim=-1),
            "m": m, "md": md, "dx": dx, "w_l": left / alpha, "w_r": right / alpha}


def _gap(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    if got.is_complex() and not want.is_complex():  # the pilot's window holds m as complex
        want = want.to(torch.complex128)
    return ((got.to(want.dtype) - want).abs().max() / scale).item()


def _rms(t: torch.Tensor) -> torch.Tensor:
    return t.abs().square().mean().sqrt()


def tails(cfg: dict, d: dict) -> dict:
    """What a stream decoded as ``d`` (:func:`decode`) carries after the
    block, by the driver's names: each FIR's window (its input's last
    n_taps samples) and each de-emphasis's last direct-form-II value."""
    L = cfg["n_taps"]
    return {"align_w": d["m"][:, -L:], "pilot_w": d["m"][:, -L:], "mono_w": d["md"][:, -L:],
            "diff_w": d["dx"][:, -L:], "deemph_l": d["w_l"][:, -1:], "deemph_r": d["w_r"][:, -1:]}


def state_gap(cfg: dict, ref: dict, after: dict) -> float:
    """Largest gap of the carried windows and states against the reference's,
    each over the rms of the stream it carries."""
    want = tails(cfg, ref)
    streams = {"align_w": "m", "pilot_w": "m", "mono_w": "md", "diff_w": "dx",
               "deemph_l": "w_l", "deemph_r": "w_r"}
    return max(_gap(after[k], want[k], _rms(ref[s])) for k, s in streams.items())


def check(cfg, wl, blocks, start, kept, device, control: bool = False):
    per_block = []
    for item in [start] + list(kept):
        r = blocks[item.index % len(blocks)]
        st0 = item.before
        ref = decode(cfg, r, st0)
        if control:  # the same steps in TF32 in the program's place; it carries the state exactly
            c = decode(cfg, r, st0, control=True)
            left, right, pilot = c["left"], c["right"], c["pilot"]
            gap, errors = state_gap(cfg, ref, tails(cfg, c)), 0
        else:
            left, right, pilot = item.out
            st1 = item.after
            gap = state_gap(cfg, ref, st1)
            errors = int((st1["r_prime"] != r[:, -1]).sum().item()
                         + (st1["pilot_w"] != st1["align_w"].to(st1["pilot_w"].dtype))
                         .sum().item())
            if item.index == 0:  # the stream starts from zeros
                errors += int(sum((v != 0).sum().item() for v in st0.values()))
        per_block.append({
            "left_gap": _gap(left, ref["left"], _rms(ref["left"])),
            "right_gap": _gap(right, ref["right"], _rms(ref["right"])),
            "pilot_gap": _gap(pilot, ref["pilot"], _rms(ref["pilot"])),
            "state_gap": gap,
            "state_errors": errors,
        })
    return per_block, {"compared_blocks": len(per_block)}
