"""Symbol-synchronizer scan kernels, K3 and K4 (BASELINE config[1]).

Port of :mod:`yagi_tpu.kernels.symscan` (symsync.rs:230-266 semantics). Per
channel and input sample, the timing loop runs E emission slots: select
branch bb = clip(b, 0, P−1) of the matched (mf) and derivative (dmf)
filterbanks, q = clip(mr·dr + mi·di, −1, 1), a first-order loop filter, the
rate/τ update, and an emission of (mr, mi)·(1/k) while b < P; a valid sample
then wraps τ by one (see ``csrc/symscan.cuh``, the loop body both kernels
include).

Layouts are the port's, channel-major:

* ``state`` float32 [9, C], rows (b, bf, τ, τ_decim, rate, δ, dec, v0, v1);
  the new state comes back in a fresh array;
* ``locked`` bool [C], ``radj`` float32 [C] (rate adjustment), ``pll_a`` and
  ``pll_b`` float32 [3] on the device (the loop reads pll_a[1] and pll_b[0]);
* ``n_valid``: a 0-d int64 tensor on the device, or None for all n; it is
  never read back to the host;
* outputs ``y`` complex64 [C, n, E] and ``valid`` bool [C, n, E], then the
  new state, then ``deferred`` int32 [C]: the valid samples after whose E
  slots an emission was still due (b < P before the wrap), which the
  bounded slots defer to the next sample (yagi_tpu's ``pending``,
  ``filter/symsync.py::_emit_sample``; ``QamRx.overflow_count`` adds them
  up). Every route returns ``(y, valid, state', deferred)``.

Two kernels, each beside its plain version, chosen by the tensors' device
(CPU runs the plain version; CUDA launches the kernel or raises, nothing
falls back):

* K4, :func:`symsync_scan_apply` (``csrc/symscan.cu``, replaces
  ``yagi_tpu/kernels/symscan.py::_kernel``): fed the all-branch stream
  ``xs4`` float32 [C, n, 4P] with groups **[re·mf | re·dmf | im·mf |
  im·dmf]** (K4's order; yagi_tpu's ``branch_outputs_4xP`` stacks
  (re·mf, im·mf, re·dmf, im·dmf) instead). Plain version
  :func:`symsync_scan_reference`; the two are bit-identical. Its blocks
  stage tiles of each channel's rows in shared memory in the layout
  :func:`scan_layout` chooses from P and E; a row too long to stage runs its
  direct instance, which reads the rows from device memory.
* K3, :func:`symsync_fused_apply` (replaces ``symscan.py::_kernel_fused``):
  fed the raw samples ``xa`` complex64 [C, n + L] (the L-sample window, then
  the block) and the taps ``g`` float32 [2P, L], g[i, j] = [mf; dmf][i, L−1−j]
  applied to xa[t+1+j]; it forms only the selected branch's four dots per
  slot. Plain version :func:`symsync_fused_reference`: every branch's dots by
  :func:`branch_outputs`, which sums in the kernel's order, then K4's loop;
  the two are bit-identical.

Why one summation order, and not yagi_tpu's all-branch matmul for K3's plain
version: the loop feeds its decisions back, so dots that differ by an ulp
make whole channels part ways. On the H100 at config[1] (C = 1024, 3965
valid samples of random input), K3 with fused multiply-add dots against a
cuBLAS-matmul plain version differed in 112 of 1024 channels, emission counts by up to 6, where
yagi_tpu's TPU record expected one moved emission per 4M samples. With one
order, K3, K4 and the XLA-form scan agree bit for bit.

Both loops multiply by 1/k as the TPU kernels do (``symscan.py:132``);
yagi_tpu's XLA scan divides by k (``symsync.py:169``); the two agree for
k = 2. The XLA form is :func:`symsync_scan_xla`, the oracle of
``Symsync.execute_slots(backend="xla")``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import trace
from ._check import aligned16, check_tensors, route

__all__ = [
    "STATE_ROWS",
    "branch_outputs",
    "fused_fits",
    "fused_smem_bytes",
    "scan_layout",
    "symsync_fused_apply",
    "symsync_fused_reference",
    "symsync_scan_apply",
    "symsync_scan_launch",
    "symsync_scan_reference",
    "symsync_scan_xla",
]

STATE_ROWS = 9  # b, bf, tau, tau_decim, rate, delta, dec, v0, v1
LANES = 4  # K3's lanes per dot, each summing every LANES-th tap (csrc/symscan.cu)
FUSED_SMEM_LIMIT = 232448  # bytes of shared memory a block can use on an H100
_FUSED_CHANS, _FUSED_TILE = 8, 128  # K3's channels per block and samples per tile
_SCAN_CHANS, _SCAN_MAX_TILE = 8, 32  # K4's channels per block and rows per tile, at most


def _pitch(length: int, rem: int, mod: int) -> int:
    """The smallest pitch ≥ length with pitch ≡ rem (mod ``mod``)."""
    return length + (rem - length) % mod


def fused_smem_bytes(L: int, P: int) -> int:
    """K3's shared memory per block for L taps a branch and P branches, the
    arithmetic of ``csrc/symscan.cu::fused_layout``: two copies of all 2P tap
    rows at bank-spreading pitches, and two tiles of 8 channels' samples."""
    fpitch = _pitch(L, 4, 32)
    rpitch = _pitch(fpitch + L, 16, 32)
    cstride = _pitch(P * rpitch, 8, 32)
    spitch = _pitch(_FUSED_TILE + L, 4, 16)
    return 4 * 2 * cstride + 8 * 2 * _FUSED_CHANS * spitch


def fused_fits(L: int, P: int) -> bool:
    """Whether K3 takes this bank: its taps are staged whole, so a large P·L
    passes the block's shared memory. ``Symsync`` on ``"auto"`` then runs K4
    over :func:`branch_outputs`' stream, which has no such limit and gives
    the same bits (the counterpart of yagi_tpu's ``fused_ok`` gate, with the
    card's limit in place of the VMEM budget)."""
    return fused_smem_bytes(L, P) <= FUSED_SMEM_LIMIT


def scan_layout(P: int, E: int) -> tuple[int, int, int] | None:
    """K4's staged layout for P branches and E slots a sample: ``(chans,
    w, bytes)``, channels a block, rows (samples) a tile and the block's
    shared memory, two tiles of x [chans, w, 4P] float32 and of the parked
    y [chans, w·E] complex64 and valid [chans, w·E] bytes:
    2·chans·w·(16P + 9E) bytes (``csrc/symscan.cu::yagi_symsync_scan_staged``
    computes the same from chans and w). 8 channels a block and the widest
    tile up to 32 rows that fits the card's 232,448 bytes; where not one row
    of 8 channels fits, fewer channels a block, one row a tile; None where
    not one row of one channel fits (P > 7262 at E = 2): the direct
    instance, which reads the rows from device memory, takes that bank."""
    per = 2 * (16 * P + 9 * E)  # bytes of a (channel, row), double buffered
    w = min(_SCAN_MAX_TILE, FUSED_SMEM_LIMIT // (_SCAN_CHANS * per))
    if w >= 1:
        return _SCAN_CHANS, w, _SCAN_CHANS * w * per
    chans = FUSED_SMEM_LIMIT // per
    return (chans, 1, chans * per) if chans >= 1 else None


def branch_outputs(xa, g):
    """All-branch matched/derivative filter outputs [C, n, 4P], groups
    [re·mf | re·dmf | im·mf | im·dmf], from xa [C, n + L] and g [2P, L]:
    y[c, t, i] = Σ_j g[i, j]·xa[c, t+1+j].

    Summed in K3's order, one rounded multiply or add at a time: lane l of
    the dot's LANES adds the products of taps j ≡ l (mod LANES) in increasing
    j, then the lanes combine as (s0 + s1) + (s2 + s3) (K3 runs the four
    dots on four such groups of a channel's 16 lanes). So each output equals
    K3's dot bit for bit, depends only on its own L samples (the same for any
    block length), and is the same on any device.
    """
    L = g.shape[1]
    n = xa.shape[-1] - L
    xt = xa[..., 1:]
    planes = []
    for plane in (xt.real, xt.imag):
        lanes = []
        for lane in range(LANES):
            acc = None
            for j in range(lane, L, LANES):
                term = plane[..., j : j + n, None] * g[:, j]
                acc = term if acc is None else acc + term
            if acc is None:  # a lane with no tap (L < LANES) holds 0
                acc = g.new_zeros(plane.shape[:-1] + (n, g.shape[0]))
            lanes.append(acc)
        while len(lanes) > 1:  # the kernel's xor butterfly, as lane 0 sees it
            lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
        planes.append(lanes[0])
    return torch.cat(planes, dim=-1)


def _loop(pick, n: int, n_valid, state, locked, radj, pll_a, pll_b, *, P: int, E: int,
          k_out: int, k: int, xla: bool):
    """The timing loop over n samples in torch ops, one [C] vector per
    quantity. ``pick(t, bb)`` returns the selected branch's (mr, dr, mi, di).
    ``xla`` selects yagi_tpu's XLA-scan output form, where(active, m / k, 0)
    (``symsync._emit_sample``), over the kernels' active·m·(1/k)."""
    b, bf, tau, tau_d, rate, delta, dec, pv0, pv1 = state.unbind(0)
    dev = state.device
    pa1, pb0 = pll_a[1], pll_b[0]
    notlocked = ~locked
    kf = torch.tensor(float(k), dtype=torch.float32, device=dev)
    kinv = torch.tensor(1.0 / k, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    vflags = torch.arange(n, device=dev) < (n if n_valid is None else n_valid)
    deferred = torch.zeros(state.shape[1], dtype=torch.int32, device=dev)
    yr_all, yi_all, act_all = [], [], []
    for t in range(n):
        vs = vflags[t]
        for _ in range(E):
            active = (b < P) & vs
            mr, dr, mi, di = pick(t, b.clamp(0, P - 1).long())
            if k_out == 1:
                do_t = (dec == 1.0) & active & notlocked
            else:
                due = (dec == float(k_out)) & active
                do_t = due & notlocked
                dec = torch.where(due, zero, dec)
            q = (mr * dr + mi * di).clamp(-1.0, 1.0)
            v0 = q - pa1 * pv0
            q_hat = pb0 * v0
            rate_new = rate + radj * q_hat
            delta_new = rate_new + q_hat

            pv1 = torch.where(do_t, pv0, pv1)
            pv0 = torch.where(do_t, v0, pv0)
            rate = torch.where(do_t, rate_new, rate)
            delta = torch.where(do_t, delta_new, delta)
            tau_d = torch.where(do_t, tau, tau_d)

            dec = torch.where(active, 1.0 if k_out == 1 else dec + 1.0, dec)
            tau = torch.where(active, tau + delta, tau)
            bf = torch.where(active, tau * P, bf)
            b = torch.where(active, torch.round(bf), b)
            if xla:
                yr_all.append(torch.where(active, mr / kf, zero))
                yi_all.append(torch.where(active, mi / kf, zero))
            else:
                af = active.to(torch.float32)
                yr_all.append(af * mr * kinv)
                yi_all.append(af * mi * kinv)
            act_all.append(active)
        deferred = deferred + ((b < P) & vs).to(torch.int32)
        vsf = vs.to(torch.float32)
        tau = tau - vsf
        bf = bf - vsf * P
        b = b - vsf * P
    C = state.shape[1]
    y = torch.complex(torch.stack(yr_all, -1), torch.stack(yi_all, -1)).reshape(C, n, E)
    valid = torch.stack(act_all, -1).reshape(C, n, E)
    return y, valid, torch.stack([b, bf, tau, tau_d, rate, delta, dec, pv0, pv1]), deferred


def _stream_pick(xs4, P: int):
    offs = torch.arange(4, device=xs4.device) * P

    def pick(t, bb):
        return xs4[:, t].gather(1, bb[:, None] + offs).unbind(1)

    return pick


def symsync_scan_reference(xs4, n_valid, state, locked, radj, pll_a, pll_b, *, P: int,
                           E: int, k_out: int, k: int):
    """K4's plain version: its loop as torch ops over the time axis, the
    branch picked with a gather from ``xs4`` [C, n, 4P] (groups [re·mf |
    re·dmf | im·mf | im·dmf]). Same arguments and result as
    :func:`symsync_scan_apply`."""
    return _loop(_stream_pick(xs4, P), xs4.shape[1], n_valid, state, locked, radj, pll_a,
                 pll_b, P=P, E=E, k_out=k_out, k=k, xla=False)


def symsync_scan_xla(xs4, n_valid, state, locked, radj, pll_a, pll_b, *, P: int, E: int,
                     k_out: int, k: int):
    """yagi_tpu's XLA scan (``symsync._emit_sample``) over the same stream:
    K4's loop with the emitted values where(active, m / k, 0). Plain torch on
    any device; the oracle of ``Symsync.execute_slots(backend="xla")``."""
    return _loop(_stream_pick(xs4, P), xs4.shape[1], n_valid, state, locked, radj, pll_a,
                 pll_b, P=P, E=E, k_out=k_out, k=k, xla=True)


def symsync_fused_reference(xa, g, n_valid, state, locked, radj, pll_a, pll_b, *, P: int,
                            E: int, k_out: int, k: int):
    """K3's plain version: every branch's mf/dmf outputs by
    :func:`branch_outputs` (K3's summation order), then K4's loop. Same
    arguments and result as :func:`symsync_fused_apply`."""
    return symsync_scan_reference(branch_outputs(xa, g), n_valid, state, locked, radj, pll_a,
                                  pll_b, P=P, E=E, k_out=k_out, k=k)


def _check_loop_args(fn, device, C: int, n_valid, state, locked, radj, pll_a, pll_b) -> None:
    f32 = torch.float32
    specs = {
        "state": (state, (STATE_ROWS, C), f32), "locked": (locked, (C,), torch.bool),
        "radj": (radj, (C,), f32), "pll_a": (pll_a, (3,), f32), "pll_b": (pll_b, (3,), f32),
    }
    if n_valid is not None:
        specs["n_valid"] = (n_valid, (), torch.int64)
    check_tensors(fn, device, specs)


def _outputs(C: int, n: int, E: int, device):
    y = torch.empty((C, n, E), dtype=torch.complex64, device=device)
    valid = torch.empty((C, n, E), dtype=torch.bool, device=device)
    st = torch.empty((STATE_ROWS, C), dtype=torch.float32, device=device)
    return y, valid, st, torch.empty(C, dtype=torch.int32, device=device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


@trace.kernel
def symsync_scan_apply(xs4, n_valid, state, locked, radj, pll_a, pll_b, *, P: int, E: int,
                       k_out: int, k: int):
    """K4: the symsync timing loop over a precomputed all-branch stream.

    ``xs4`` float32 [C, n, 4P], groups [re·mf | re·dmf | im·mf | im·dmf];
    the other arguments and the result ``(y, valid, state', deferred)`` as
    the module docstring says. The counterpart of
    ``yagi_tpu/kernels/symscan.py::symsync_scan``.

    CPU tensors run :func:`symsync_scan_reference`; CUDA tensors launch the
    kernel (counted in ``symsync_scan_apply.launches``) or raise: the staged
    instance in :func:`scan_layout`'s layout, or the direct one where that
    is None.
    """
    if not isinstance(xs4, torch.Tensor) or xs4.dim() != 3:
        raise ValueError("symsync_scan_apply: xs4 must be a [C, n, 4P] tensor")
    C, n, _ = xs4.shape
    if C < 1 or n < 1 or P < 1 or E < 1 or k_out < 1:
        raise ValueError("symsync_scan_apply: need C, n, P, E, k_out >= 1")
    check_tensors("symsync_scan_apply", xs4.device, {"xs4": (xs4, (C, n, 4 * P), torch.float32)})
    _check_loop_args("symsync_scan_apply", xs4.device, C, n_valid, state, locked, radj, pll_a,
                     pll_b)
    if route(xs4.device, "symsync_scan_apply") == "reference":
        return symsync_scan_reference(xs4, n_valid, state, locked, radj, pll_a, pll_b, P=P,
                                      E=E, k_out=k_out, k=k)

    out = symsync_scan_launch(xs4, n_valid, state, locked, radj, pll_a, pll_b, P=P, E=E,
                              k_out=k_out, k=k, layout=scan_layout(P, E))
    symsync_scan_apply.launches += 1
    return out


def symsync_scan_launch(xs4, n_valid, state, locked, radj, pll_a, pll_b, *, P: int, E: int,
                        k_out: int, k: int, layout):
    """One launch of K4 on CUDA tensors already checked, not counted: the
    staged instance in ``layout`` (:func:`scan_layout`'s ``(chans, w, _)``),
    or the direct instance for None. :func:`symsync_scan_apply` passes its
    layout; the A/B and timing tools pass None to run the direct one."""
    from ._build import launch

    C, n, _ = xs4.shape
    xs4 = aligned16(xs4)  # the staged instance copies 16-byte chunks
    y, valid, st, deferred = _outputs(C, n, E, xs4.device)
    args = (xs4.data_ptr(), _ptr(n_valid), state.data_ptr(), locked.data_ptr(),
            radj.data_ptr(), pll_a.data_ptr(), pll_b.data_ptr(), y.data_ptr(),
            valid.data_ptr(), st.data_ptr(), deferred.data_ptr(), C, n, P, E, k_out,
            ctypes.c_float(np.float32(1.0 / k)))
    if layout is None:  # a row too long to stage: the direct instance
        launch(symsync_scan_apply, xs4.device, "yagi_symsync_scan", *args)
    else:
        launch(symsync_scan_apply, xs4.device, "yagi_symsync_scan_staged", *args, *layout[:2])
    return y, valid, st, deferred


@trace.kernel
def symsync_fused_apply(xa, g, n_valid, state, locked, radj, pll_a, pll_b, *, P: int, E: int,
                        k_out: int, k: int):
    """K3: the symsync timing loop computing the selected branch's dots from
    the raw samples.

    ``xa`` complex64 [C, n + L], the L-sample window then the block; ``g``
    float32 [2P, L], g[i, j] = [mf; dmf][i, L−1−j]; the other arguments and
    the result ``(y, valid, state', deferred)`` as the module docstring says.
    The counterpart of ``yagi_tpu/kernels/symscan.py::symsync_scan_fused``.

    CPU tensors run :func:`symsync_fused_reference`; CUDA tensors launch the
    kernel (counted in ``symsync_fused_apply.launches``) or raise.
    """
    if not isinstance(g, torch.Tensor) or g.dim() != 2 or g.shape[0] != 2 * P:
        raise ValueError("symsync_fused_apply: g must be a [2P, L] tensor")
    L = g.shape[1]
    if not isinstance(xa, torch.Tensor) or xa.dim() != 2 or xa.shape[1] <= L:
        raise ValueError("symsync_fused_apply: xa must be a [C, n + L] tensor with n >= 1")
    C, n = xa.shape[0], xa.shape[1] - L
    if C < 1 or P < 1 or E < 1 or k_out < 1:
        raise ValueError("symsync_fused_apply: need C, P, E, k_out >= 1")
    check_tensors("symsync_fused_apply", xa.device, {
        "xa": (xa, (C, n + L), torch.complex64), "g": (g, (2 * P, L), torch.float32),
    })
    _check_loop_args("symsync_fused_apply", xa.device, C, n_valid, state, locked, radj, pll_a,
                     pll_b)
    if route(xa.device, "symsync_fused_apply") == "reference":
        return symsync_fused_reference(xa, g, n_valid, state, locked, radj, pll_a, pll_b, P=P,
                                       E=E, k_out=k_out, k=k)

    if not fused_fits(L, P):
        raise ValueError(f"symsync_fused_apply: L = {L} taps on P = {P} branches need "
                         f"{fused_smem_bytes(L, P)} bytes of shared memory a block, past the "
                         f"card's {FUSED_SMEM_LIMIT}")

    from ._build import launch

    y, valid, st, deferred = _outputs(C, n, E, xa.device)
    launch(symsync_fused_apply, xa.device, "yagi_symsync_fused",
           xa.data_ptr(), g.data_ptr(), _ptr(n_valid), state.data_ptr(), locked.data_ptr(),
           radj.data_ptr(), pll_a.data_ptr(), pll_b.data_ptr(), y.data_ptr(), valid.data_ptr(),
           st.data_ptr(), deferred.data_ptr(), C, n, L, P, E, k_out,
           ctypes.c_float(np.float32(1.0 / k)))
    symsync_fused_apply.launches += 1
    return y, valid, st, deferred
