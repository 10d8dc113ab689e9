"""Parallel linear-recurrence evaluation (log-depth all-pole filters).

Port of :mod:`yagi_tpu.filter._linrec`. An IIR filter's feedback path
v0[n] = x[n] − Σₖ aₖ·v0[n−k] is a linear time-invariant recurrence: with the
order-m state s[n] = [v0[n], …, v0[n−m+1]] it reads s[n] = M·s[n−1] + e·x[n]
with the companion matrix M, and the affine maps (A, b) compose
associatively:

    (A₂, b₂) ∘ (A₁, b₁) = (A₂A₁, A₂b₁ + b₂)

torch has no associative scan, so the prefixes are taken with the doubling
(Hillis–Steele) scan: at step d every element composes with the one 2^d
before it, ⌈log₂ T⌉ passes over the block. The numerator is applied
afterwards by the caller (``kernels/iir.py::iir_chunked_reference``).

Outputs match the sequential recurrence to fp32 tolerance (the same
recurrence in another summation order; yagi_tpu's associative scan uses
another tree again). This is the plain version of the ``iir_chunked``
kernel and the CPU route of every ``parallelize()``d filter. yagi_tpu's
numerical note holds here too: for TF filters of order > 2 with highly
non-normal companion matrices the powers Mⁿ can have large transients.
"""

from __future__ import annotations

import torch

__all__ = ["allpole_parallel"]


def allpole_parallel(a_tail, v_init, x):
    """All-pole recurrence v0[n] = x[n] − Σₖ a_tail[k−1]·v0[n−k], log-depth.

    a_tail: [m] feedback taps (a₁…a_m, a₀ already normalized out);
    v_init:  [..., m] previous v0 values, newest first (the DF-II v-buffer);
    x:       [..., T] input block (time last).

    Returns (v0 [..., T], v_final [..., m]), the state convention of the
    sequential recurrence in ``IirFilter.execute_block``.
    """
    m = int(a_tail.shape[0])
    T = x.shape[-1]
    dt = torch.promote_types(a_tail.dtype, x.dtype)
    x = x.to(dt)
    if m == 0 or T == 0:  # no feedback, or no samples
        return x, v_init.to(dt)
    a_tail = a_tail.to(dt)

    if m == 1:
        # scalar form: s[n] = p·s[n−1] + x[n]; a_cum[t] = p^(t+1)
        a_cum = (-a_tail[0]).expand(T).clone()
        b_cum = x
        s = 1
        while s < T:
            b_cum = torch.cat([b_cum[..., :s], a_cum[s:] * b_cum[..., :-s] + b_cum[..., s:]], -1)
            a_cum = torch.cat([a_cum[:s], a_cum[s:] * a_cum[:-s]])
            s *= 2
        v0 = a_cum * v_init[..., :1] + b_cum
        return v0, v0[..., -1:]

    # companion matrix: first row −a, shifted identity below
    M = torch.cat([-a_tail[None, :], torch.eye(m, dtype=dt, device=x.device)[:-1]], 0)
    a_cum = M.expand(T, m, m).clone()  # [T, m, m]
    b_cum = torch.zeros(x.shape + (m,), dtype=dt, device=x.device)  # [..., T, m]
    b_cum[..., 0] = x
    s = 1
    while s < T:
        b_new = torch.einsum("tij,...tj->...ti", a_cum[s:], b_cum[..., :-s, :]) + b_cum[..., s:, :]
        b_cum = torch.cat([b_cum[..., :s, :], b_new], -2)
        a_cum = torch.cat([a_cum[:s], a_cum[s:] @ a_cum[:-s]])
        s *= 2
    # s[n] = A_cum[n]·s₀ + b_cum[n];  s₀ = v_init (already newest-first)
    st = torch.einsum("tij,...j->...ti", a_cum, v_init.to(dt)) + b_cum
    return st[..., 0], st[..., -1, :]
