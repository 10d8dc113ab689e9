"""Fused RX-chain kernel: FIR → P× polyphase interp → NCO mix-down.

Port of :mod:`yagi_tpu.kernels.chain` (BASELINE config[0]; reference
semantics: firfilt.rs execute_block → resamp.rs:141-154 u32-phase polyphase
emission → osc.rs:179 block mix). For an integer rate P (P | 2^24, P | npfb)
the resampler's schedule is static: output m = P·n + δ consumes input n
through branch δ·npfb/P, and the carried phase is always 0. FIR ⊛ branch
filters collapse into P combined filters g_δ of K ≤ 128 taps, computed in
float64 on the host (:func:`chain_matrices`).

Two implementations of one function, chosen by the device of the input:

* :func:`fused_chain_reference`, plain torch: the banded form of the TPU
  kernel, Z[b] = [X[b−1] | X[b]] @ [G_prev; G_cur] per 128-sample row,
  then the exact u32 NCO ramp. CPU tensors run it.
* ``csrc/chain.cu``, the hand-written Hopper kernel, which replaces
  ``yagi_tpu/kernels/chain.py::_chain_kernel``. CUDA tensors run it, or the
  call raises; nothing falls back. It takes the combined filters compact,
  [P, Kp] (:func:`compact_taps`), any P that :func:`chain_matrices` accepts
  and any channel count.

Two layouts: :func:`fused_chain_apply` on float32 planes (re, im), and
:func:`fused_chain_apply_c64` on interleaved complex64 in and out, the same
kernel source reading and writing the other layout, so a complex caller
pays no split or join pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .._src.struct import U32
from ..nco.osc import PHASE_TO_RAD
from ._check import check_tensors, route

__all__ = ["chain_matrices", "compact_taps", "fused_chain_apply", "fused_chain_apply_c64",
           "fused_chain_reference"]

_LANE = 128
_TAP_STEP = 16  # the kernel walks the taps 4, 8 or 16 at a time


def chain_matrices(h, scale, branches, p: int) -> np.ndarray:
    """Banded chain matrices G [2, 128, 128·P] from FIR taps + PFB branches.

    ``h``: FIR taps (h[0] multiplies the newest sample), ``scale``: FIR output
    scale, ``branches``: [npfb, L] polyphase bank in convolution order.

    Output column u = P·t + δ holds the δ-th polyphase stream's tap for
    output sample index m = P·(128b + t) + δ:
      G[1][j, u] = g_δ[t - j]        (current input row)
      G[0][j, u] = g_δ[128 + t - j]  (previous input row)
    where g_δ = (scale·h) ⊛ branches[δ·npfb/P], computed in float64.
    """
    h = np.asarray(h, dtype=np.float64) * float(np.asarray(scale).real)
    branches = np.asarray(branches, dtype=np.float64)
    npfb, L = branches.shape
    if npfb % p:
        raise ValueError("P must divide npfb")
    if (1 << 24) % p:
        raise ValueError("P must divide 2^24 for an exact static phase schedule")
    K = len(h) + L - 1
    if K > _LANE:
        raise ValueError(f"combined filter length {K} exceeds one row ({_LANE})")
    g = np.stack([np.convolve(h, branches[d * (npfb // p)]) for d in range(p)])

    j = np.arange(_LANE)[:, None]  # source index within a row
    t = np.arange(_LANE)[None, :]  # output "input-sample" index within a row
    G = np.zeros((2, _LANE, _LANE * p), dtype=np.float64)
    for d in range(p):
        k_cur = t - j
        k_prev = _LANE + t - j
        cur = np.where((k_cur >= 0) & (k_cur < K), g[d][np.clip(k_cur, 0, K - 1)], 0.0)
        prev = np.where(
            (k_prev >= 0) & (k_prev < K), g[d][np.clip(k_prev, 0, K - 1)], 0.0
        )
        G[1, :, d::p] = cur
        G[0, :, d::p] = prev
    return G.astype(np.float32)


def compact_taps(g, p: int) -> np.ndarray:
    """The P combined filters back out of :func:`chain_matrices`'s banded G:
    float32 [P, Kp], row δ holding g_δ[0..K) and zeros up to Kp, K rounded up
    to a multiple of 16 (the layout ``csrc/chain.cu`` takes). Row 0 of the
    current-row band holds g_δ[t] at column P·t + δ."""
    g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
    if g.shape != (2, _LANE, _LANE * p):
        raise ValueError(f"g has shape {g.shape}, expected {(2, _LANE, _LANE * p)}")
    rows = g[1, 0].reshape(_LANE, p).T  # [P, 128]
    used = np.flatnonzero(rows.any(axis=0))
    k = int(used[-1]) + 1 if used.size else 1
    kp = -(-k // _TAP_STEP) * _TAP_STEP
    return np.ascontiguousarray(rows[:, :kp], dtype=np.float32)


def _nco_rotate(zr, zi, theta0, dtheta):
    """(zr + j·zi)·e^{−jθ_m} with θ_m = θ0 + m·dθ in wrapping u32."""
    idx = torch.arange(zr.shape[-1], dtype=torch.int64, device=zr.device)
    theta = (theta0 + idx * dtheta) & U32
    t = theta.to(torch.float32) * PHASE_TO_RAD
    c, s = torch.cos(t), torch.sin(t)
    return zr * c + zi * s, zi * c - zr * s


def fused_chain_reference(xr, xi, g, hist_r, hist_i, theta0, dtheta, *, p: int):
    """Plain-torch fused chain: same arguments and result as
    :func:`fused_chain_apply`, as the TPU kernel's banded fp32 matmul."""
    C, T = xr.shape
    nb = T // _LANE
    gm = g.reshape(2 * _LANE, _LANE * p)  # stacked [G_prev; G_cur]

    def band(x, hist):
        x3 = x.reshape(C, nb, _LANE)
        prev = torch.cat([hist[:, None], x3[:, :-1]], dim=1)
        return (torch.cat([prev, x3], dim=-1) @ gm).reshape(C, T * p)

    return _nco_rotate(band(xr, hist_r), band(xi, hist_i), theta0, dtheta)


def _check(fn: str, planes: dict, g, hist_r, hist_i, theta0, dtheta, p: int) -> None:
    first = next(iter(planes.values()))[0]
    if not isinstance(first, torch.Tensor) or first.dim() != 2:
        raise ValueError(f"{fn}: the input must be a [C, T] tensor")
    C, T = first.shape
    if T % _LANE:
        raise ValueError(f"block length {T} must be a multiple of {_LANE}")
    f32, i64 = torch.float32, torch.int64
    # K ≤ 128 is the band's shape: chain_matrices refuses longer filters
    check_tensors(fn, first.device, {
        **{name: (t, (C, T), dtype) for name, (t, dtype) in planes.items()},
        "g": (g, (2, _LANE, _LANE * p), f32),
        "hist_r": (hist_r, (C, _LANE), f32), "hist_i": (hist_i, (C, _LANE), f32),
        "theta0": (theta0, (), i64), "dtheta": (dtheta, (), i64),
    })


def _kernel_taps(fn: str, taps, g, p: int, C: int, T: int) -> torch.Tensor:
    """The compact taps for a launch (built from ``g`` where the caller holds
    none, which reads ``g`` back to the host), after the kernel's range checks."""
    if p < 1 or p & (p - 1):
        raise ValueError(f"{fn}: P must be a power of two, got {p}")
    if T * p >= 1 << 31:
        raise ValueError(f"block [{C}, {T}] at P={p} exceeds the kernel's index range")
    if taps is None:
        taps = torch.from_numpy(compact_taps(g, p)).to(g.device)
    kp = taps.shape[-1] if isinstance(taps, torch.Tensor) and taps.dim() == 2 else 0
    if kp < _TAP_STEP or kp > _LANE or kp % _TAP_STEP:
        raise ValueError(f"{fn}: taps must be [P, Kp] with Kp a multiple of {_TAP_STEP} up to "
                         f"{_LANE}")
    check_tensors(fn, g.device, {"taps": (taps, (p, kp), torch.float32)})
    return taps


@trace.kernel
def fused_chain_apply(xr, xi, g, hist_r, hist_i, theta0, dtheta, *, p: int, taps=None):
    """Run the fused chain over one planar block.

    xr/xi: [C, T] float32 input planes (T a multiple of 128); g: [2, 128,
    128·P] from :func:`chain_matrices`; hist_r/i: [C, 128] trailing input
    history of the previous block (zeros at stream start); theta0/dtheta:
    0-d int64 tensors holding the u32 NCO state; ``taps``: float32 [P, Kp]
    from :func:`compact_taps` (g) on the same device, which only the kernel
    reads (built from ``g`` where it is None).

    Returns (yr, yi) [C, T·P]. State advance (caller): hist' = x[:, -128:],
    theta' = theta0 + (T·P)·dtheta mod 2^32.

    CPU tensors run :func:`fused_chain_reference`; CUDA tensors launch the
    kernel (counted in ``fused_chain_apply.launches``) or raise.
    """
    f32 = torch.float32
    _check("fused_chain_apply", {"xr": (xr, f32), "xi": (xi, f32)}, g, hist_r, hist_i, theta0,
           dtheta, p)
    if route(xr.device, "fused_chain_apply") == "reference":
        return fused_chain_reference(xr, xi, g, hist_r, hist_i, theta0, dtheta, p=p)

    from ._build import launch

    C, T = xr.shape
    taps = _kernel_taps("fused_chain_apply", taps, g, p, C, T)
    yr = torch.empty((C, T * p), dtype=f32, device=xr.device)
    yi = torch.empty_like(yr)
    launch(fused_chain_apply, xr.device, "yagi_chain_planar",
           xr.data_ptr(), xi.data_ptr(), taps.data_ptr(), hist_r.data_ptr(), hist_i.data_ptr(),
           theta0.data_ptr(), dtheta.data_ptr(), yr.data_ptr(), yi.data_ptr(), C, T, p,
           taps.shape[1])
    fused_chain_apply.launches += 1
    return yr, yi


@trace.kernel
def fused_chain_apply_c64(x, g, hist_r, hist_i, theta0, dtheta, *, p: int, taps=None):
    """The fused chain over one interleaved block: x complex64 [C, T] → y
    complex64 [C, T·P]; the other arguments as :func:`fused_chain_apply`
    (the history stays two planes). The values equal the planar call's bit
    for bit.

    CPU tensors run :func:`fused_chain_reference` on the planes' views; CUDA
    tensors launch the kernel's interleaved instance (counted in
    ``fused_chain_apply_c64.launches``) or raise.
    """
    _check("fused_chain_apply_c64", {"x": (x, torch.complex64)}, g, hist_r, hist_i, theta0,
           dtheta, p)
    if route(x.device, "fused_chain_apply_c64") == "reference":
        return torch.complex(*fused_chain_reference(x.real, x.imag, g, hist_r, hist_i, theta0,
                                                    dtheta, p=p))

    from ._build import launch

    C, T = x.shape
    taps = _kernel_taps("fused_chain_apply_c64", taps, g, p, C, T)
    y = torch.empty((C, T * p), dtype=torch.complex64, device=x.device)
    launch(fused_chain_apply_c64, x.device, "yagi_chain_c64",
           x.data_ptr(), taps.data_ptr(), hist_r.data_ptr(), hist_i.data_ptr(),
           theta0.data_ptr(), dtheta.data_ptr(), y.data_ptr(), C, T, p, taps.shape[1])
    fused_chain_apply_c64.launches += 1
    return y
