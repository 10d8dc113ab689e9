"""Arbitrary-rate resampling values through the prototype FIR and a Farrow
interpolator (``Resamp(interp="farrow")``).

Port of :mod:`yagi_tpu.filter._farrow_resamp`. The reference's resampler
(resamp.rs:141-154) evaluates the prototype h at the fractional emission
times τ_m through a 256-branch bank, rounding the fraction to 1/256.
(h ⊛ x) is bandlimited by h, so its samples on the half-sample grid,
z2[2i] = branch 0 at input i and z2[2i+1] = branch npfb/2, determine it;
a polynomial interpolator (the Farrow structure: K+1 FIRs c_k ⊛ z2 combined
as Σ_k μ^k (c_k ⊛ z2)) evaluates it at the exact offsets μ. The
coefficients are least-squares designed on the host (copied from yagi_tpu),
with error below the reference's own 1/256 branch rounding. The schedule
(counts, times, carried phase) stays the u32 one.

yagi_tpu computes these values with a gather-free layout for the TPU (a
periodic grid, 0/1 selection matmuls, a bf16 hi/lo split, planar
flattening). The port computes the same function directly: the K+1 FIRs
over the whole half-sample grid as one banded matmul, then a gather at each
emission's grid position. Emissions whose window would reach before the
block (the head) or past it (the tail) take the exact branch dot instead,
in the same zones as yagi_tpu.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._conv import causal_conv_valid, multi_branch_conv
from ..kernels.resamp import branch_dots

# Farrow design: T taps, polynomial order K, fit band [0, _BAND] cycles/sample
_T = 12
_K = 4
_BAND = 0.33

_design_cache: dict = {}
_PICK_CACHE: dict = {}


def farrow_coeffs(T: int = _T, K: int = _K, band: float = _BAND) -> np.ndarray:
    """[K+1, T] polynomial-FIR matrix C: interp(z, i+μ) ≈ Σ_k μ^k (c_k⊛z)[i].

    Least-squares fit of Σ_k μ^k Σ_t c_k[t]·e^{-j2πf(t−d)} to e^{+j2πfμ}
    over f ∈ [0, band], μ ∈ [0, 1), with group delay d = T/2 − 1 + μ
    convention: v_k[i] uses samples z[i−d .. i−d+T−1], so μ ∈ [0,1)
    interpolates between z[i] and z[i+1]. Solved on a dense (f, μ) grid in
    f64; cached per (T, K, band).
    """
    key = (T, K, band)
    if key in _design_cache:
        return _design_cache[key]
    d = T // 2 - 1  # z[i] sits at tap index d when μ=0
    fs = np.linspace(0, band, 96)
    mus = np.linspace(0, 1, 33, endpoint=False)
    t = np.arange(T)
    # basis matrix: rows (f, μ) × columns (k, t)
    rows = []
    rhs = []
    for f in fs:
        e_t = np.exp(2j * np.pi * f * (t - d))  # response of tap t at freq f
        for mu in mus:
            basis = np.concatenate([(mu ** k) * e_t for k in range(K + 1)])
            rows.append(basis)
            rhs.append(np.exp(2j * np.pi * f * mu))
    A = np.asarray(rows)
    b = np.asarray(rhs)
    # real coefficients: stack real/imag parts of the complex LS system
    Ar = np.concatenate([A.real, A.imag])
    br = np.concatenate([b.real, b.imag])
    sol, *_ = np.linalg.lstsq(Ar, br, rcond=None)
    C = sol.reshape(K + 1, T)
    _design_cache[key] = C.astype(np.float64)
    return _design_cache[key]


def farrow_design_error_db(T: int = _T, K: int = _K, band: float = _BAND) -> float:
    """Worst-case interpolation error of the designed Farrow over the band."""
    C = farrow_coeffs(T, K, band)
    d = T // 2 - 1
    t = np.arange(T)
    worst = 0.0
    for f in np.linspace(0, band, 157):
        e_t = np.exp(2j * np.pi * f * (t - d))
        for mu in np.linspace(0, 1, 41, endpoint=False):
            got = sum((mu ** k) * np.dot(C[k], e_t) for k in range(K + 1))
            err = abs(got - np.exp(2j * np.pi * f * mu))
            worst = max(worst, err)
    return 20.0 * np.log10(max(worst, 1e-300))


def pick_design(band_hz: float) -> tuple[int, int]:
    """Smallest (T, K) whose LS design error beats −50 dB over the band.

    Band here is the HALF-grid band (≤ 0.249), where T=8 often suffices for
    the default fc=0.25 prototype.
    """
    key = round(band_hz, 3)
    if key not in _PICK_CACHE:
        choice = (12, 4)
        for T in (8, 10, 12):
            done = False
            for K in (3, 4):
                if farrow_design_error_db(T, K, band_hz) < -50.0:
                    choice = (T, K)
                    done = True
                    break
            if done:
                break
        _PICK_CACHE[key] = choice
    return _PICK_CACHE[key]


def farrow_resample_values(
    xa: torch.Tensor,
    branches: torch.Tensor,
    step_nom: int,
    n: int,
    n_m: torch.Tensor,
    branch: torch.Tensor,
    lo_bits: torch.Tensor,
    valid: torch.Tensor,
    band: float = _BAND,
) -> torch.Tensor:
    """Values of the u32 emission schedule through the FIR and the Farrow
    interpolator: [..., cap], zero where not ``valid``.

    ``xa``: [..., L−1+n] input with its history (the gather path's layout);
    ``n_m``: exact source indices (phase_m >> 24) [cap]; ``branch``: the u32
    branch indices (for the exact head and tail); ``lo_bits``: the low 32
    bits of each emission's phase; ``step_nom``: the certified u32 step;
    ``band``: the prototype's band, halved here for the 2× grid. Within the
    design error of the PFB gather path (≈ −55 dB, below the reference's
    1/256 branch floor ≈ −45 dB).
    """
    npfb = branches.shape[0]
    cap = n_m.shape[0]
    band_hz = min(0.249, band / 2.0)
    T, K = pick_design(band_hz)
    C = farrow_coeffs(T=T, K=K, band=band_hz)
    d = T // 2 - 1
    lookahead = (T - d) // 2 + 2  # future INPUT samples the window reaches
    max_n0 = max(0, (step_nom - 1) >> 24) + 2  # entry offset bound (+margin)

    # z2: (h ⊛ x) at integer (branch 0) and half-integer (branch npfb/2)
    # offsets, interleaved: z2[2i], z2[2i+1]
    z_e = causal_conv_valid(xa, branches[0])  # [..., n]
    z_o = causal_conv_valid(xa, branches[npfb // 2])
    z2 = torch.stack([z_e, z_o], dim=-1).reshape(z_e.shape[:-1] + (2 * n,))
    # v_k[p] = Σ_t C_k[t]·z2[p − d + t], zero outside the block: the K+1
    # Farrow FIRs as one bank, taps in convolution order (reversed)
    z2p = F.pad(z2, (d, T - 1 - d))
    bank = torch.from_numpy(np.ascontiguousarray(C[:, ::-1], dtype=np.float32))
    v = multi_branch_conv(z2p, bank.to(xa.device))  # [..., K+1, 2n]

    # each emission's grid position p_m = phase_m >> 23 and offset μ_m
    p_m = 2 * n_m + ((lo_bits >> 23) & 1)
    mu = (lo_bits & 0x7FFFFF).to(torch.float32) * (2.0 ** -23)
    vm = v[..., p_m.clamp(0, max(2 * n - 1, 0))]  # [..., K+1, cap]
    y = vm[..., K, :]
    for k in range(K - 1, -1, -1):
        y = y * mu + vm[..., k, :]

    def exact(lo: int, hi: int) -> torch.Tensor:
        return branch_dots(xa, branches, n_m[lo:hi].clamp(0, n - 1), branch[lo:hi])

    # the exact head: the Farrow window reaches z2 before the block
    head_lim = (T // 2) // 2 + 1
    hcap = min(cap, int((head_lim + 1) * (1 << 24) // step_nom) + 3)
    if hcap > 0:
        keep = n_m[:hcap] <= head_lim
        y = torch.cat([torch.where(keep, exact(0, hcap), y[..., :hcap]), y[..., hcap:]], -1)
    # the exact tail: the Farrow window needs inputs past the block. The
    # first slot that can reach the zone is bounded from the nominal step:
    # n_m ≤ entry_n0 + ((m·step)>>24) + 1 with entry_n0 ≤ max_n0
    first = ((n - lookahead - 2 * max_n0 - 1) << 24) // step_nom - 4
    sl = max(0, min(cap, first))
    if sl < cap:
        keep = n_m[sl:] >= n - lookahead - max_n0
        y = torch.cat([y[..., :sl], torch.where(keep, exact(sl, cap), y[..., sl:])], -1)
    return torch.where(valid, y, torch.zeros((), dtype=y.dtype, device=y.device))
