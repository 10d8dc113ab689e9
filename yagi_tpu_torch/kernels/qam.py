"""QamRx's equalizer / carrier loop over the symsync slots: ``qam_eq_scan``
(BASELINE config[3]).

yagi_tpu runs this loop as a ``lax.scan`` whose body is ``eq_slot``
(``yagi_tpu/chains/qam.py:173-247``), which XLA compiles into one device
loop; it wrote no Pallas kernel for it. In eager torch a slot is ~75 small
ops, so the port runs the loop as a hand-written CUDA kernel
(``csrc/qam.cu``) beside its plain version :func:`qam_eq_scan_reference`.
Up to :data:`MAX_REG_H_LEN` taps it runs in rounds: the state (w, θ, dθ, the
EVM sums) moves only on a slot where can_adapt holds, and can_adapt and
every slot's window follow from the inputs alone, so the slots after one
adapting slot up to the next (a segment) are all decided from the state the
segment starts with, :data:`ROUND_SLOTS` of them at once (a round), and only
a round's last slot, where it adapts, updates the state. A planner warp
plans each tile of :data:`ROUND_TILE` slots from the inputs, a tile ahead; a
round never crosses a tile. The kernel adds its rounds to the device counter
``qam_eq_scan.rounds`` and the wrapper the slots it hands over to
``qam_eq_scan.slots`` (:mod:`yagi_tpu_torch.trace`). A longer equalizer runs
the kernel's shared-memory instance, which walks every slot with 8 lanes a
channel (the decision's distances split over the lanes, the same dot order
and argmin), chosen from h_len before the launch.

Per channel, for each emission slot in stream order (``eq_slot`` op for op,
the math of ``Eqlms.push/execute/step``, eqlms.rs:125-187): push the slot into
the h_len window; y = Σ conj(w)·buf; is_sym = valid ∧ sym_phase = 0;
can_adapt = is_sym ∧ Σ|x|² > ½·h_len; derotate v = y·e^{−jθ}; decide the
nearest table point ŝ; the PLL's phase error pe = Im(v·ŝ*)/|ŝ|² moves
θ += dθ + α·pe, dθ += β·pe; the LMS update toward ŝ·e^{jθ} once h_len samples
are in; sym_phase steps mod k_eq on a valid slot; the EVM sums add |v − ŝ|².
The window only moves on a valid slot, the weights only on an adapting
symbol, θ, dθ and the EVM only where can_adapt.

Every reduction has one evaluation order, the kernel's: the h_len-tap dot
left to right over the taps in increasing index, (x2_sum + |x|²) − x2[0],
and the decision the first table index of the smallest distance (a NaN
distance counts as smallest, as ``torch.argmin`` and ``jnp.argmin`` take it;
the kernel's lanes each take every other point, every 8th in its
shared-memory instance, and then the smallest of (NaN first, distance,
index), which is the same index).
Every operation is rounded on its own, so the kernel equals the plain
version bit for bit, in rounds as slot by slot: a round computes each slot
by the same operations from the same state; the loop feeds its decisions
back, so one ulp would part a channel for good on noise.

Layout, channel-major: ``y`` complex64 [C, S] and ``valid`` bool [C, S], the
S = n·E slots of a block in stream order (``Symsync`` slots [C, n, E]
reshaped); ``table`` complex64 [M]; ``mu``, ``alpha``, ``beta`` float32 [C];
``state`` a dict of :data:`STATE_FIELDS`: ``w``, ``buffer`` complex64
[C, h_len], ``x2`` float32 [C, h_len], ``x2_sum`` float32 [C], ``count``
int32 [C], ``theta``, ``dtheta`` float32 [C], ``sym_phase`` int32 [C],
``evm_accum``, ``evm_count`` float32 [C]. Both return ``(syms, soft, mask,
state')``: ``syms`` int64 [C, S] (yagi_tpu's u32 symbols), ``soft``
complex64 [C, S] (the derotated equalizer output), ``mask`` bool [C, S]
(is_sym), and the new state in fresh arrays.
"""

from __future__ import annotations

import torch

from .. import trace
from ._check import check_tensors, route

__all__ = ["STATE_FIELDS", "qam_eq_scan_apply", "qam_eq_scan_reference"]

STATE_FIELDS = ("w", "buffer", "x2", "x2_sum", "count", "theta", "dtheta", "sym_phase",
                "evm_accum", "evm_count")
MAX_REG_H_LEN = 16  # up to here the window lives in registers; past it, in shared memory
_SMEM_LIMIT = 232448  # bytes of shared memory a block can use on an H100
# csrc/qam.cu's register instance: slots a round, channels per block, slots a
# tile, each channel's ring of valid samples
ROUND_SLOTS, _RCHANS, ROUND_TILE, _RING = 4, 16, 64, 256
_CHANS, _PITCH, _BPITCH = 16, 65, 68  # its shared-memory instance: channels per block, row pitches


def smem_bytes(m: int, h_len: int) -> int:
    """Shared memory of one ``qam_eq_scan`` block (``csrc/qam.cu``): the table
    and, up to :data:`MAX_REG_H_LEN` taps, three tiles of slots (y, valid),
    two tiles' plans and each channel's rings over its valid samples; past
    it, the tiles of slots and outputs and each channel's window and
    weights, 5·h_len floats at an odd stride."""
    if h_len <= MAX_REG_H_LEN:
        tile, ring = _RCHANS * (ROUND_TILE + 1), _RCHANS * (_RING + MAX_REG_H_LEN + 1)
        masks = 2 * _RCHANS * (ROUND_TILE // 32)
        return (8 * (m + 3 * tile + ring) + 4 * (2 * ring + 2 * tile + masks + 2 * _RCHANS)
                + 3 * _RCHANS * (ROUND_TILE + 4) + 2 * 2 * _RCHANS * (ROUND_TILE + 2))
    tiles = 8 * (m + 2 * _CHANS * _PITCH) + 4 * _CHANS * _PITCH + 2 * _CHANS * _BPITCH
    return tiles + 4 * _CHANS * ((5 * h_len) | 1)


def _dot(a):
    """Σ over the last axis, left to right in increasing index."""
    acc = a[:, 0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j]
    return acc


def qam_eq_scan_reference(y, valid, table, mu, alpha, beta, state, *, k_eq: int = 2):
    """``qam_eq_scan``'s plain version: the loop as torch ops over the
    slots, one [C] (or [C, h_len]) tensor per quantity, each op rounded on its
    own. Same arguments and result as :func:`qam_eq_scan_apply`."""
    h_len = state["w"].shape[1]
    br, bi = state["buffer"].real, state["buffer"].imag
    wr, wi = state["w"].real, state["w"].imag
    x2t, x2s, cnt = state["x2"], state["x2_sum"], state["count"]
    theta, dtheta, sph = state["theta"], state["dtheta"], state["sym_phase"]
    eacc, ecnt = state["evm_accum"], state["evm_count"]
    tr, ti = table.real, table.imag
    syms, soft_r, soft_i, mask = [], [], [], []
    for s in range(y.shape[1]):
        xr, xi, vi = y.real[:, s], y.imag[:, s], valid[:, s]
        # push (eqlms.rs:125)
        x2n = xr * xr + xi * xi
        br_p = torch.cat([br[:, 1:], xr[:, None]], 1)
        bi_p = torch.cat([bi[:, 1:], xi[:, None]], 1)
        x2_p = torch.cat([x2t[:, 1:], x2n[:, None]], 1)
        x2s_p = x2s + x2n - x2t[:, 0]
        cnt_p = cnt + 1
        # execute (eqlms.rs:137): y = Σ conj(w)·buf
        yr = _dot(wr * br_p + wi * bi_p)
        yi = _dot(wr * bi_p - wi * br_p)
        is_sym = vi & (sph == 0)
        can_adapt = is_sym & (x2s_p > 0.5 * h_len)
        # carrier derotation v = y·e^{−jθ} and the nearest table point
        co, sn = torch.cos(theta), torch.sin(theta)
        vs_r = yr * co + yi * sn
        vs_i = yi * co - yr * sn
        dr = vs_r[:, None] - tr
        di = vs_i[:, None] - ti
        sym = torch.argmin(dr * dr + di * di, dim=1)
        sr, si = tr[sym], ti[sym]
        # PLL (phase error against the decision)
        pe = (vs_i * sr - vs_r * si) / torch.clamp(sr * sr + si * si, min=1e-12)
        theta_n = theta + dtheta + alpha * pe
        dtheta_n = dtheta + beta * pe
        # LMS update (eqlms.rs:170-187) toward d = ŝ·e^{jθ}
        ar = (sr * co - si * sn) - yr
        ai = (si * co + sr * sn) - yi
        g = (mu / torch.clamp(x2s_p, min=1e-20))[:, None]
        wr_u = wr + g * (ar[:, None] * br_p + ai[:, None] * bi_p)
        wi_u = wi + g * (ar[:, None] * bi_p - ai[:, None] * br_p)
        adapt = (can_adapt & (cnt_p >= h_len))[:, None]
        vt = vi[:, None]
        br, bi, x2t = torch.where(vt, br_p, br), torch.where(vt, bi_p, bi), torch.where(vt, x2_p, x2t)
        x2s, cnt = torch.where(vi, x2s_p, x2s), torch.where(vi, cnt_p, cnt)
        wr, wi = torch.where(adapt, wr_u, wr), torch.where(adapt, wi_u, wi)
        theta = torch.where(can_adapt, theta_n, theta)
        dtheta = torch.where(can_adapt, dtheta_n, dtheta)
        sph = torch.where(vi, sph ^ 1 if k_eq == 2 else (sph + 1) % k_eq, sph)
        er, ei = vs_r - sr, vs_i - si
        eacc = torch.where(can_adapt, eacc + (er * er + ei * ei), eacc)
        ecnt = torch.where(can_adapt, ecnt + 1.0, ecnt)
        syms.append(sym)
        soft_r.append(vs_r)
        soft_i.append(vs_i)
        mask.append(is_sym)
    new = dict(w=torch.complex(wr, wi), buffer=torch.complex(br, bi), x2=x2t, x2_sum=x2s,
               count=cnt, theta=theta, dtheta=dtheta, sym_phase=sph, evm_accum=eacc,
               evm_count=ecnt)
    soft = torch.complex(torch.stack(soft_r, 1), torch.stack(soft_i, 1))
    return torch.stack(syms, 1), soft, torch.stack(mask, 1), new


@trace.kernel
def qam_eq_scan_apply(y, valid, table, mu, alpha, beta, state, *, k_eq: int = 2):
    """``qam_eq_scan``: the equalizer / carrier loop over a block's slots,
    arguments and result as the module docstring says; on the card any
    h_len whose block fits the shared memory (:func:`smem_bytes`; h_len ≤ 654
    with a 16-point table).

    CPU tensors run :func:`qam_eq_scan_reference`; CUDA tensors launch the
    kernel (counted in ``qam_eq_scan_apply.launches``; the register
    instance's slots and rounds in the counters ``qam_eq_scan.slots`` and
    ``qam_eq_scan.rounds``) or raise.
    """
    if not isinstance(y, torch.Tensor) or y.dim() != 2 or y.shape[0] < 1 or y.shape[1] < 1:
        raise ValueError("qam_eq_scan_apply: y must be a [C, S] tensor with C, S >= 1")
    if set(state) != set(STATE_FIELDS):
        raise ValueError(f"qam_eq_scan_apply: state must hold exactly {STATE_FIELDS}")
    if k_eq < 1:
        raise ValueError("qam_eq_scan_apply: k_eq must be >= 1")
    C, S = y.shape
    h_len = state["w"].shape[-1] if state["w"].dim() == 2 else 0
    if not isinstance(table, torch.Tensor) or table.dim() != 1 or table.shape[0] < 1:
        raise ValueError("qam_eq_scan_apply: table must be a [M] tensor with M >= 1")
    f32, i32, c64 = torch.float32, torch.int32, torch.complex64
    vec = {k: (state[k], (C,), f32) for k in ("x2_sum", "theta", "dtheta", "evm_accum",
                                                "evm_count")}
    check_tensors("qam_eq_scan_apply", y.device, {
        "y": (y, (C, S), c64), "valid": (valid, (C, S), torch.bool),
        "table": (table, (table.shape[0],), c64), "mu": (mu, (C,), f32),
        "alpha": (alpha, (C,), f32), "beta": (beta, (C,), f32),
        "w": (state["w"], (C, h_len), c64), "buffer": (state["buffer"], (C, h_len), c64),
        "x2": (state["x2"], (C, h_len), f32), "count": (state["count"], (C,), i32),
        "sym_phase": (state["sym_phase"], (C,), i32), **vec,
    })
    if h_len < 1:
        raise ValueError("qam_eq_scan_apply: h_len must be >= 1")
    if route(y.device, "qam_eq_scan_apply") == "reference":
        return qam_eq_scan_reference(y, valid, table, mu, alpha, beta, state, k_eq=k_eq)
    if smem_bytes(table.shape[0], h_len) > _SMEM_LIMIT:
        raise ValueError(f"qam_eq_scan_apply: h_len = {h_len} with a {table.shape[0]}-point "
                         f"table needs {smem_bytes(table.shape[0], h_len)} bytes of shared "
                         f"memory a block, past the card's {_SMEM_LIMIT}")

    from ._build import launch

    syms = torch.empty((C, S), dtype=torch.int64, device=y.device)
    soft = torch.empty_like(y)
    mask = torch.empty_like(valid)
    new = {k: torch.empty_like(state[k]) for k in STATE_FIELDS}
    rounds = trace.device_counter("qam_eq_scan.rounds", y.device)
    launch(qam_eq_scan_apply, y.device, "yagi_qam_eq_scan_counted",
           y.data_ptr(), valid.data_ptr(), table.data_ptr(), mu.data_ptr(), alpha.data_ptr(),
           beta.data_ptr(), *(state[k].data_ptr() for k in STATE_FIELDS), syms.data_ptr(),
           soft.data_ptr(), mask.data_ptr(), *(new[k].data_ptr() for k in STATE_FIELDS),
           C, S, table.shape[0], h_len, k_eq, rounds.data_ptr())
    qam_eq_scan_apply.launches += 1
    if h_len <= MAX_REG_H_LEN:  # the instance that runs rounds
        trace.count("qam_eq_scan.slots", C * S)
    return syms, soft, mask, new
