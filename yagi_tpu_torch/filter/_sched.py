"""Static-schedule polyphase resampling as one banded matmul.

Port of :mod:`yagi_tpu.filter._sched`. The arbitrary resampler's u32
schedule is exactly periodic whenever the reduced numerator P divides 2^24
(step·P = Q·2^24, so the phase returns to its entry value every Q inputs —
resamp.rs:103,141-154). Any such periodic (src, branch) schedule is lifted
into a banded matmul: s periods of outputs per row, window rows concatenated,
taps placed in a [K, W] band matrix whose column j' = t·P + j holds
branch[j]'s taps at offset t·Q + src[j].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# beyond this band height the matrix is mostly zeros (heavy decimation)
_MAX_K = 4096


def sched_matmul_ok(p: int, q: int, sub_len: int) -> bool:
    """Would the banded form be sensible for this schedule?"""
    s = max(1, -(-128 // p))
    krow = s * q
    nband = 1 + max(0, -(-(sub_len - 1) // krow))
    return nband * krow <= _MAX_K


def sched_banded_matmul(
    xa: torch.Tensor,
    branches: torch.Tensor,
    src_off: np.ndarray,
    br_idx: np.ndarray,
    q: int,
    n_periods: int,
) -> torch.Tensor:
    """Periodic static-schedule resample of ``xa`` → [..., n_periods·P].

    ``xa``: input incl. the (sub_len−1)-sample left history; output j of
    period t reads ``xa[..., t·Q + src_off[j] : +sub_len]``. ``branches``:
    [npfb, sub_len] taps in convolution order. ``src_off``/``br_idx``:
    length-P host arrays.

    y[..., t·P + j] = Σ_l xa[..., t·Q+src_off[j]+l] · branches[br_idx[j], L−1−l]
    """
    if xa.is_complex() and not branches.is_complex():
        return torch.complex(
            sched_banded_matmul(xa.real, branches, src_off, br_idx, q, n_periods),
            sched_banded_matmul(xa.imag, branches, src_off, br_idx, q, n_periods),
        )
    src_off = np.asarray(src_off, dtype=np.int64)
    br_idx = np.asarray(br_idx, dtype=np.int64)
    p = len(src_off)
    L = branches.shape[1]
    dtype = torch.promote_types(xa.dtype, branches.dtype)
    xa = xa.to(dtype)
    br = branches.to(dtype)
    dev = br.device

    s = max(1, -(-128 // p))  # periods per output row
    W = s * p
    krow = s * q
    nband = 1 + max(0, -(-(L - 1) // krow))
    K = nband * krow
    n_rows = -(-n_periods // s)
    total = (n_rows - 1) * krow + K

    batch_shape = xa.shape[:-1]
    m0 = xa.shape[-1]
    xp = F.pad(xa.reshape(-1, m0), (0, total - m0))
    x3 = xp.reshape(-1, n_rows - 1 + nband, krow)
    f = torch.cat([x3[:, d : d + n_rows] for d in range(nband)], dim=-1)

    # band matrix G[u, j'] = br_rev[branch_j, u − (t·Q + src_off[j])]
    u = np.arange(K)[:, None]
    t = np.arange(W)[None, :] // p
    j = np.arange(W)[None, :] % p
    rel = u - (t * q + src_off[j])
    valid = torch.from_numpy((rel >= 0) & (rel < L)).to(dev)
    idx_m = torch.from_numpy((L - 1) - np.clip(rel, 0, L - 1)).to(dev)
    idx_b = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(br_idx[j], (K, W)))).to(dev)
    g = torch.where(valid, br[idx_b, idx_m], torch.zeros((), dtype=dtype, device=dev))
    y = f @ g
    return y.reshape(batch_shape + (n_rows * W,))[..., : n_periods * p]


def u32_static_schedule(step: int, bits: int, npfb: int):
    """(P, Q, src_off, br_idx) of the u32 phase schedule, or None.

    The u32 accumulator (step = round(2^24/r), emit while phase ≤ 0xffffff,
    branch = top ``bits`` of the 24-bit phase — resamp.rs:103,141-154) is
    exactly periodic with P = 2^24/gcd(step, 2^24). Practical when P ≤ 256.
    """
    step = int(step)
    if step == 0:
        return None
    g = math.gcd(step, 1 << 24)
    p = (1 << 24) // g
    q = step // g
    if p > 256:
        return None
    src_off = np.empty(p, dtype=np.int64)
    br_idx = np.empty(p, dtype=np.int64)
    for j in range(p):
        ph = j * step  # python int, exact
        src_off[j] = ph >> 24
        br_idx[j] = (ph >> (24 - bits)) & (npfb - 1)
    return p, q, src_off, br_idx
