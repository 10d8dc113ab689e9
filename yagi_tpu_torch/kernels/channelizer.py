"""Fused M = 64 polyphase channelizer kernel (BASELINE config[4]).

Port of :mod:`yagi_tpu.kernels.channelizer` (algorithm: liquid firpfbch, see
multichannel/firpfbch.py). For analyzer step i (M-block X[i]):

  s_b[i]   = x[iM − b]                      (commutator)
  u[b, i]  = Σ_j br[b, j] · s_b[i−j]        (branch FIR)
  y[k, i]  = Σ_b u[b, i] · e^{+2πi·bk/M} · scale   (IDFT)

Output is step-major [T, M] planar (y[t, k] = channel k at step t).

Two implementations of one function, chosen by the device of the input:

* :func:`fused_channelizer_reference`, plain torch in the TPU kernel's own
  formulation: two M-blocks per 128-lane row, the commutator as a one-row
  shift with lanes 0 and 64 patched, and the IDFT as ``[R2, 256] @
  [256, 128]`` dots against the stacked block-diagonal twiddles. CPU tensors
  run it.
* ``csrc/channelizer.cu``, the hand-written Hopper kernel, which replaces
  ``yagi_tpu/kernels/channelizer.py::_chan_kernel``. CUDA tensors run it, or
  the call raises; nothing falls back. It computes the IDFT as an FFT:
  since b(c) = (M − c) mod M, W'[c, k] = scale·e^{−2πi·ck/M}, so
  y[t, ·] = scale · DFT(u[t, ·]) over the lanes (:func:`branch_outputs`
  gives u). Up to 64 taps a branch its persistent blocks keep a ring of
  input rows in shared memory; a longer bank (``create_kaiser(m=33)``:
  p = 66) runs its second instance, which walks the taps in tiles of 64,
  for any p ≥ 1.

With ``fm=(r_prime, ref)`` the call is ChannelizerFmRx's whole step: the
channels, Freqdem's discriminator along the step axis (row 0 against each
channel's carried last output ``r_prime``) and the new state. Up to 64 taps a
branch the card runs the kernel's FM instance, one launch that writes all of
it (counted in the ``channelizer.fm_epilogue`` counter); past that, and on the
CPU, the channelizer and then :func:`fm_reference`, its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ._check import aligned16, check_tensors, route

__all__ = ["branch_outputs", "channelizer_tables", "fm_reference", "fused_channelizer_apply",
           "fused_channelizer_reference", "halo_rows", "phase_step"]

_LANE = 128
_M = 64  # channels (the kernel is specialized to M = 64, the config[4] workload)
_S = _LANE // _M  # analyzer steps per 128-lane row (= 2)
_MAX_ONE_PASS = 64  # csrc/channelizer.cu kMaxOnePass: taps a branch of the one-pass instance


def channelizer_tables(branches: np.ndarray, scale: float):
    """Host tables: per-tap lane vectors + block-diagonal IDFT twiddles.

    branches: [M, p] conv order (branch b tap j multiplies s_b[i−j]).

    Lane c carries branch b(c) = (M−c) mod M, so the commutator is
    s_{b(c)}[m] = X[m−1, c] (c ≥ 1) and s_0[m] = X[m, 0]: a one-step shift with
    no lane reversal. The branch permutation is folded into these tables:
    taps[j, c] = branches[b(c), j] and H = blockdiag(W', W') with
    W'[c, k] = e^{+2πi·b(c)·k/M}·scale. The tables equal yagi_tpu's field for
    field, so a yagi_tpu FusedChannelizer's state loads as it is.
    """
    M, p = branches.shape
    if M != _M:
        raise ValueError(f"kernel is specialized to M={_M}")
    perm = (-np.arange(M)) % M  # b(c)
    taps = np.tile(branches[perm].astype(np.float32).T, (1, _S))  # [p, 128]
    b = np.arange(M)
    w = np.exp(2j * np.pi * np.outer(perm, b) / M) * scale
    h = np.zeros((_LANE, _LANE), np.complex128)
    for s in range(_S):
        h[s * M : (s + 1) * M, s * M : (s + 1) * M] = w
    return taps, h.real.astype(np.float32), h.imag.astype(np.float32)


def halo_rows(p: int) -> int:
    """Rows of 128 history samples a p-tap bank needs: the deepest access is
    X[i−p], plus one row for the one-step-delayed view."""
    return max((p + 1) // 2, (p - 1) // 2 + 1)


def branch_outputs(xr, xi, taps, hist_r, hist_i, *, p: int):
    """The branch FIR outputs u [T, 64] (re, im), step-major, lane c in
    column c (branch b(c)), as the TPU kernel forms them: two M-blocks per
    128-lane row, the commutator as a one-row shift with lanes 0 and 64
    patched, tap j summed after taps 0 .. j − 1. Arguments as
    :func:`fused_channelizer_apply`."""
    t2 = xr.shape[-1] // _LANE
    halo = halo_rows(p)
    lane = torch.arange(_LANE, device=xr.device)
    patch = (lane & (_M - 1)) == 0  # lanes 0 and 64

    def streams(x, hist):
        # ext rows: [history | block], row r = [X[2r] | X[2r+1]]
        ext = torch.cat([hist.reshape(halo, _LANE), x.reshape(t2, _LANE)])
        prev = torch.cat([torch.zeros_like(ext[:1]), ext[:-1]])
        shift1 = torch.cat([prev[:, _M:], ext[:, :_M]], dim=1)  # [X[2r−1] | X[2r]]
        # steps (2r, 2r+1), and the one-step-delayed view (2r−1, 2r)
        return torch.where(patch, ext, shift1), torch.where(patch, shift1, prev)

    def branch_fir(s2, s2d):
        acc = None
        for j in range(p):
            # tap j delays by j steps: even j shifts the (2r, 2r+1) grid by j/2
            # rows, odd j uses the delayed view
            src = s2 if j % 2 == 0 else s2d
            shift = j // 2
            term = taps[j] * src[halo - shift : halo - shift + t2]
            acc = term if acc is None else acc + term
        return acc.reshape(t2 * _S, _M)

    return branch_fir(*streams(xr, hist_r)), branch_fir(*streams(xi, hist_i))


def fused_channelizer_reference(xr, xi, taps, hr, hi, hist_r, hist_i, *, p: int):
    """Plain-torch channelizer: same arguments and result as
    :func:`fused_channelizer_apply`, as the TPU kernel computes it over the
    whole block at once (one tile of all rows): :func:`branch_outputs`, then
    the IDFT as ``[R2, 256] @ [256, 128]`` dots against the stacked
    block-diagonal twiddles.

    On the card the IDFT dots are float32 matmuls: set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` for a full-fp32 oracle.
    """
    t2 = xr.shape[-1] // _LANE
    ur, ui = branch_outputs(xr, xi, taps, hist_r, hist_i, p=p)
    # complex IDFT as two stacked K=256 dots:
    #   yr = [ur|ui] @ [H_re; −H_im],  yi = [ur|ui] @ [H_im; H_re]
    u = torch.cat([ur.reshape(t2, _LANE), ui.reshape(t2, _LANE)], dim=1)
    yr = u @ torch.cat([hr, -hi])
    yi = u @ torch.cat([hi, hr])
    return yr.reshape(t2 * _S, _M), yi.reshape(t2 * _S, _M)


def phase_step(pr, pi, rr, ri, out: torch.Tensor) -> torch.Tensor:
    """``out`` = atan2(pr·ri − pi·rr, pr·rr + pi·ri) = arg(conj(r′)·r),
    elementwise, from the planes of r′ (pr, pi) and r (rr, ri)."""
    im = pr * ri
    im.addcmul_(pi, rr, value=-1.0)
    re = pr * rr
    re.addcmul_(pi, ri)
    return torch.atan2(im, re, out=out)


def fm_reference(yr, yi, r_prime, ref: float) -> torch.Tensor:
    """The FM instance's plain version, after the channelizer: Freqdem's
    discriminator fm [T, 64] = arg(conj(y[t − 1])·y[t])·ref along the step
    axis of the planes yr, yi [T, 64], row 0 against ``r_prime`` [64]
    (complex64), every row by :func:`phase_step`."""
    fm = torch.empty_like(yr)
    phase_step(r_prime.real, r_prime.imag, yr[0], yi[0], fm[0])
    phase_step(yr[:-1], yi[:-1], yr[1:], yi[1:], fm[1:])
    return fm.mul_(ref)


def _two_step_fm(yr, yi, xr, xi, hist_r, hist_i, r_prime, ref: float):
    """The FM route's outputs from the channels of a launch or the reference,
    in span ``yagi.chzfm.demod``: :func:`fm_reference`, then the new state as
    new tensors, y[T − 1] and the history ``cat(hist, x)[−nh:]``."""
    with trace.span("yagi.chzfm.demod"):
        fm = fm_reference(yr, yi, r_prime, ref)
        nh = hist_r.shape[0]
        hist = [x[-nh:].clone() if x.shape[0] >= nh else torch.cat([h, x])[-nh:]
                for h, x in ((hist_r, xr), (hist_i, xi))]
        return yr, yi, fm, torch.complex(yr[-1], yi[-1]), *hist


def _check(xr, xi, taps, hr, hi, hist_r, hist_i, p: int, r2: int) -> None:
    if not isinstance(xr, torch.Tensor) or xr.dim() != 1:
        raise ValueError("fused_channelizer_apply: xr must be a 1-d tensor")
    n = xr.shape[0]
    if n == 0 or n % _LANE:
        raise ValueError("stream length must be a positive multiple of 128")
    if (n // _LANE) % r2:
        raise ValueError(f"need length divisible by {r2 * _LANE}")
    nh = halo_rows(p) * _LANE
    f32 = torch.float32
    check_tensors("fused_channelizer_apply", xr.device, {
        "xr": (xr, (n,), f32), "xi": (xi, (n,), f32), "taps": (taps, (p, _LANE), f32),
        "hr": (hr, (_LANE, _LANE), f32), "hi": (hi, (_LANE, _LANE), f32),
        "hist_r": (hist_r, (nh,), f32), "hist_i": (hist_i, (nh,), f32),
    })


@trace.kernel
def fused_channelizer_apply(xr, xi, taps, hr, hi, hist_r, hist_i, *, p: int, r2: int = 128,
                            fm=None):
    """Channelize planar stream planes xr/xi [N] (N = T·64, T steps).

    taps [p, 128], hr/hi [128, 128] from :func:`channelizer_tables`;
    hist_r/i [halo·128] = trailing input samples of the previous block (zeros
    at stream start), halo = :func:`halo_rows` (p). N must be a multiple of
    128·r2, as on the TPU, where r2 is the rows per tile.

    Returns (yr, yi) shaped [T, 64] (step-major). State advance (caller):
    hist' = x[-halo·128:].

    With ``fm=(r_prime, ref)`` (r_prime [64] complex64, each channel's last
    output; ref Freqdem's float32 scale 1/(2π·kf)) it returns ``(yr, yi, fm,
    r_prime', hist_r', hist_i')``: the discriminator [T, 64] (its plain version
    :func:`fm_reference`) and the new state, y[T − 1] and the history
    ``cat(hist, x)[−nh:]``, every tensor new.

    CPU tensors run :func:`fused_channelizer_reference` (then
    :func:`fm_reference` and the state's copies, in span ``yagi.chzfm.demod``);
    CUDA tensors launch the kernel (counted in
    ``fused_channelizer_apply.launches``; the FM instance also in the counter
    ``channelizer.fm_epilogue``) or raise: past 64 taps a branch the tiled
    instance, then the same plain steps as the CPU's.
    """
    _check(xr, xi, taps, hr, hi, hist_r, hist_i, p, r2)
    if fm is not None:
        check_tensors("fused_channelizer_apply", xr.device,
                      {"r_prime": (fm[0], (_M,), torch.complex64)})
    if route(xr.device, "fused_channelizer_apply") == "reference":
        yr, yi = fused_channelizer_reference(xr, xi, taps, hr, hi, hist_r, hist_i, p=p)
        return (yr, yi) if fm is None else _two_step_fm(yr, yi, xr, xi, hist_r, hist_i, *fm)

    from ._build import launch

    # the kernel copies 16-byte chunks: a plane that starts elsewhere is copied
    xr, xi, hist_r, hist_i = (aligned16(t) for t in (xr, xi, hist_r, hist_i))
    n = xr.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"stream length {n} exceeds the kernel's index range")
    t, nh = n // _M, hist_r.shape[0]
    yr = torch.empty((t, _M), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    if fm is None or p > _MAX_ONE_PASS:
        launch(fused_channelizer_apply, xr.device, "yagi_channelizer_fp32",
               xr.data_ptr(), xi.data_ptr(), taps.data_ptr(), hr.data_ptr(), hi.data_ptr(),
               hist_r.data_ptr(), hist_i.data_ptr(), yr.data_ptr(), yi.data_ptr(), t, p, nh)
        fused_channelizer_apply.launches += 1
        # the tiled instance has no epilogue
        return (yr, yi) if fm is None else _two_step_fm(yr, yi, xr, xi, hist_r, hist_i, *fm)

    r_prime, ref = fm
    out = torch.empty_like(yr)
    r_new = torch.empty(_M, dtype=torch.complex64, device=xr.device)
    hr_new, hi_new = torch.empty_like(hist_r), torch.empty_like(hist_i)
    launch(fused_channelizer_apply, xr.device, "yagi_channelizer_fm",
           xr.data_ptr(), xi.data_ptr(), taps.data_ptr(), hr.data_ptr(), hist_r.data_ptr(),
           hist_i.data_ptr(), r_prime.data_ptr(), yr.data_ptr(), yi.data_ptr(), out.data_ptr(),
           r_new.data_ptr(), hr_new.data_ptr(), hi_new.data_ptr(), t, p, nh, ref)
    fused_channelizer_apply.launches += 1
    trace.count("channelizer.fm_epilogue")
    return yr, yi, out, r_new, hr_new, hi_new
