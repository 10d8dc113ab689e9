"""Batched causal convolution for the streaming filters (last axis).

Port of the stride-1 path of :mod:`yagi_tpu.filter._conv`: the reference's
per-sample window·h dotprod (firfilt.rs:241-245) as one dense matmul against
a banded tap matrix. Plain torch; no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_ROW = 128  # output samples per banded-matmul row


def causal_conv_valid(xa: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y[..., n] = Σ_k h[k] · xa[..., n + L - 1 - k].

    ``xa`` already holds the L-1 history samples on the left, so this is a
    VALID correlation with the flipped taps. The stream is viewed as rows of
    128 outputs; each row is the concatenated window [row | … | row+nband−1]
    times G[u, t] = h[t + L − 1 − u]. A complex signal with real taps runs
    as two real products.
    """
    if xa.is_complex() and not h.is_complex():
        return torch.complex(causal_conv_valid(xa.real, h), causal_conv_valid(xa.imag, h))
    dtype = torch.promote_types(xa.dtype, h.dtype)
    xa = xa.to(dtype)
    h = h.to(dtype)
    L = h.shape[0]
    batch_shape = xa.shape[:-1]
    m = xa.shape[-1]
    n_out = m - L + 1
    nb = -(-n_out // _ROW)
    nband = -(-(L + _ROW - 1) // _ROW)
    K = nband * _ROW
    total = (nb - 1) * _ROW + K

    xp = F.pad(xa.reshape(-1, m), (0, total - m))
    x3 = xp.reshape(-1, nb - 1 + nband, _ROW)
    f = torch.cat([x3[:, d : d + nb] for d in range(nband)], dim=-1)  # [B, nb, K]

    # built on the device: no host round trip per block
    ar = torch.arange(K, device=h.device)  # K ≥ _ROW
    k = ar[None, :_ROW] + (L - 1) - ar[:K, None]
    valid = (k >= 0) & (k < L)
    g = torch.where(valid, h[k.clamp(0, L - 1)], torch.zeros((), dtype=dtype, device=h.device))
    y = f @ g  # [B, nb, 128]
    return y.reshape(batch_shape + (nb * _ROW,))[..., :n_out]


def np_taps(h) -> np.ndarray:
    """Coerce host-side design output to a float32/complex64 numpy array."""
    h = np.asarray(h)
    if np.iscomplexobj(h):
        return h.astype(np.complex64)
    return h.astype(np.float32)
