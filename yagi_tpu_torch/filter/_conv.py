"""Batched causal convolution for the streaming filters (last axis).

Port of :mod:`yagi_tpu.filter._conv`: the reference's per-sample window·h
dotprod (firfilt.rs:241-245) as one dense matmul against a banded tap
matrix, for one filter (:func:`causal_conv_valid`, with a stride for the
decimators) or a bank of them (:func:`multi_branch_conv`). Plain torch.
``FirFilter``'s blocks run it on the CPU only, as the plain version of
``kernels/fir.py::fir_block_apply``; on the card they run that kernel
(``csrc/fir.cu``, direct form, no frames). Its other callers
(``firdecim``, ``firpfb``, ``misc``, ``resamp2``, ``farrow``,
``_farrow_resamp``, ``firhilb``, ``framing/`` ``bsync``, ``gmskframe`` and
``msource``, ``modem/cpm``, ``parallel/stream``) run the banded matmul on
every device. yagi_tpu's
TPU-only forms (``multi_branch_conv_tm``, ``banded_branch_matrix``) are not
ported.

Each banded matmul counts, whether tracing is on or off (``trace.py``):
``conv.frame_bytes`` (the frames [B, nb, K] it writes),
``conv.macs`` (the multiply-adds the matmul runs, B·nb·K·cols) and
``conv.tap_macs`` (those the outputs' taps need, B·n_out·L a filter), a
complex product as 4 real ones. A complex signal through real taps is two
real matmuls, each counted.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace

_ROW = 128  # output samples per banded-matmul row


def result_dtype(x_dtype, h_dtype):
    """Promotion rule matching liquid's rrrf/crcf/cccf type algebra."""
    return torch.promote_types(x_dtype, h_dtype)


def _band_frames(xa: torch.Tensor, L: int):
    """``xa`` [..., m] as rows of 128 outputs: [B, nb, K] where row b is the
    concatenated window [row b | … | row b+nband−1], K = nband·128, for a
    VALID correlation with L taps; and the output count m − L + 1."""
    m = xa.shape[-1]
    n_out = m - L + 1
    nb = -(-n_out // _ROW)
    nband = -(-(L + _ROW - 1) // _ROW)
    K = nband * _ROW
    total = (nb - 1) * _ROW + K
    xp = F.pad(xa.reshape(-1, m), (0, total - m))
    x3 = xp.reshape(-1, nb - 1 + nband, _ROW)
    return torch.cat([x3[:, d : d + nb] for d in range(nband)], dim=-1), n_out


@functools.lru_cache(maxsize=64)
def _band_index(K: int, L: int, device):
    """k[u, t] = t + L − 1 − u, the tap of window position u for output lane
    t, and where it lies in [0, L): made once for each (K, L, device), so a
    call adds no device op for it. Read only."""
    ar = torch.arange(K, device=device)  # K ≥ _ROW
    k = ar[None, :_ROW] + (L - 1) - ar[:K, None]
    return k.clamp(0, L - 1), (k >= 0) & (k < L)


def causal_conv_valid(xa: torch.Tensor, h: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """y[..., n] = Σ_k h[k] · xa[..., n·stride + L - 1 - k].

    ``xa`` already holds the L-1 history samples on the left, so this is a
    VALID correlation with the flipped taps. The stream is viewed as rows of
    128 outputs; each row is the concatenated window [row | … | row+nband−1]
    times G[u, t] = h[t + L − 1 − u]. A complex signal with real taps runs
    as two real products. A stride D runs as D stride-1 correlations, one
    per input phase, so each output costs its L taps once.
    """
    if xa.is_complex() and not h.is_complex():
        return torch.complex(causal_conv_valid(xa.real, h, stride),
                             causal_conv_valid(xa.imag, h, stride))
    if stride > 1:
        return _strided(xa, h, stride)
    return _banded(xa, h, h.shape[0])


def _count(f: torch.Tensor, cols: int, needed: int) -> None:
    """The counters of one banded matmul: the frames ``f`` [B, nb, K], the
    multiply-adds of ``f`` @ [K, cols], and the ``needed`` ones of its
    outputs' taps; a complex product counts as 4 real."""
    B, nb, K = f.shape
    real = 4 if f.is_complex() else 1
    trace.count("conv.frame_bytes", f.numel() * f.element_size())
    trace.count("conv.macs", real * B * nb * K * cols)
    trace.count("conv.tap_macs", real * needed)


def _banded(xa: torch.Tensor, h: torch.Tensor, taps: int) -> torch.Tensor:
    """:func:`causal_conv_valid` at stride 1, as one banded matmul; ``taps``
    of h's L are the filter's (the rest pad a phase of :func:`_strided`)."""
    dtype = result_dtype(xa.dtype, h.dtype)
    xa = xa.to(dtype)
    h = h.to(dtype)
    L = h.shape[0]
    batch_shape = xa.shape[:-1]
    if xa.shape[-1] < L:  # an empty block
        return xa.new_zeros(batch_shape + (0,))
    f, n_out = _band_frames(xa, L)  # [B, nb, K]
    k, valid = _band_index(f.shape[-1], L, h.device)
    g = torch.where(valid, h[k], 0)  # gathered on the device: no host round trip per block
    y = f @ g  # [B, nb, 128]
    _count(f, _ROW, f.shape[0] * n_out * taps)
    return y.reshape(batch_shape + (-1,))[..., :n_out]


def _strided(xa: torch.Tensor, h: torch.Tensor, D: int) -> torch.Tensor:
    """:func:`causal_conv_valid` at stride D. With a = n·D + L − 1 − k
    = (n + e)·D + c, output n is Σ_c Σ_e s_c[n + e]·h[L − 1 − c − e·D] over
    the D phase streams s_c[j] = xa[j·D + c]: each a stride-1 correlation
    with the taps g_c[i] = h[L − 1 − c − (E − i)·D], E = ⌊(L − 1)/D⌋."""
    L = h.shape[0]
    m = xa.shape[-1]
    n_out = max(0, (m - L) // D + 1)
    E = (L - 1) // D
    rows = n_out + E  # samples of each phase stream that the outputs read
    xp = F.pad(xa, (0, max(0, rows * D - m)))[..., : rows * D]
    xr = xp.reshape(xp.shape[:-1] + (rows, D))
    y = None
    for c in range(D):
        taps = L - 1 - c - (E - np.arange(E + 1)) * D
        idx = torch.from_numpy(np.clip(taps, 0, L - 1)).to(h.device)
        keep = torch.from_numpy(taps >= 0).to(h.device)
        g = torch.where(keep, h[idx], torch.zeros((), dtype=h.dtype, device=h.device))
        yc = _banded(xr[..., c], g, int((taps >= 0).sum()))
        y = yc if y is None else y + yc
    return y


def multi_branch_conv(xa: torch.Tensor, branches: torch.Tensor) -> torch.Tensor:
    """All-branch polyphase convolution, [..., M, N].

    ``branches`` is [M, Lsub] with branch i's taps in convolution order
    (branches[i, 0] multiplies the newest sample):
    out[..., i, n] = Σ_j branches[i, j] · xa[..., n + Lsub - 1 - j], the
    reference's FirPfbFilter::execute(i) for every branch at once
    (firpfb.rs:277-286). One banded matmul with branch-interleaved columns
    (c = t·M + i).
    """
    if xa.is_complex() and not branches.is_complex():
        return torch.complex(multi_branch_conv(xa.real, branches),
                             multi_branch_conv(xa.imag, branches))
    M, L = branches.shape
    dtype = result_dtype(xa.dtype, branches.dtype)
    xa = xa.to(dtype)
    br = branches.to(dtype)
    batch_shape = xa.shape[:-1]
    if xa.shape[-1] < L:  # an empty block
        return xa.new_zeros(batch_shape + (M, 0))
    f, n_out = _band_frames(xa, L)
    k, valid = _band_index(f.shape[-1], L, br.device)
    g = torch.where(valid[..., None], br.T[k], 0)
    y = f @ g.reshape(f.shape[-1], _ROW * M)  # [B, nb, 128·M]
    _count(f, _ROW * M, f.shape[0] * n_out * L * M)
    y = y.reshape(batch_shape + (-1, M))[..., :n_out, :]
    return y.transpose(-1, -2)


def np_taps(h) -> np.ndarray:
    """Coerce host-side design output to a float32/complex64 numpy array."""
    h = np.asarray(h)
    if np.iscomplexobj(h):
        return h.astype(np.complex64)
    return h.astype(np.float32)
