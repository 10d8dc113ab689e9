"""The AGC's gain loop over a block: ``agc_scan`` (BASELINE config[3]).

yagi_tpu runs this loop as a ``lax.scan`` (``yagi_tpu/agc/agc.py:260-276``,
``Agc.execute_block``), which XLA compiles into one device loop; it wrote no
Pallas kernel for it. In eager torch the loop is ~20 small ops per sample, so
the port runs it as a hand-written CUDA kernel (``csrc/agc.cu``), one thread
per channel, beside its plain version :func:`agc_scan_reference`.

Per channel and sample: y = g·x; y2' = (1 − α)·y2' + α·|y|²; g ← min(g·exp(−½·α·
ln max(y2', 1e-30)), 1e6) where y2' > 1e-6, held when locked; rssi =
−20·log10 g drives the squelch FSM (agc.rs:212-248), held when locked; the
output is y·s with s = 1 when locked, else the scale.

Layout, channel-major: ``x`` complex64 [C, n] (a real block is passed with
imaginary part 0); ``g``, ``y2_prime``, ``alpha``, ``scale``,
``squelch_threshold`` float32 [C]; ``locked`` bool [C]; ``squelch_mode``,
``squelch_timer`` int32 [C]; ``timeout`` an int. Both return ``(y, g,
y2_prime, squelch_mode, squelch_timer)``, ``y`` complex64 [C, n], the state in
fresh arrays. The kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from .. import trace
from ._check import check_tensors, route

__all__ = ["agc_scan_apply", "agc_scan_reference"]

# AgcSquelchMode
_DISABLED, _ENABLED, _RISE, _SIGNAL_HI, _FALL, _SIGNAL_LO, _TIMEOUT = range(7)
# next squelch mode [mode, threshold exceeded] for every mode but SIGNAL_LO's
# timeout (agc.rs:212-248); row 7 holds any other value, which disables
_NEXT_MODE = (
    (_DISABLED, _DISABLED),  # DISABLED
    (_ENABLED, _RISE),  # ENABLED
    (_FALL, _SIGNAL_HI),  # RISE
    (_FALL, _SIGNAL_HI),  # SIGNAL_HI
    (_SIGNAL_LO, _SIGNAL_HI),  # FALL
    (_SIGNAL_LO, _SIGNAL_HI),  # SIGNAL_LO, unless its timer runs out
    (_ENABLED, _ENABLED),  # TIMEOUT
    (_DISABLED, _DISABLED),
)


def squelch_step(mode, timer, te, timeout: int, table):
    """One squelch FSM transition (agc.rs:212-248) on int32 tensors: FALL
    loads the timer with ``timeout``, SIGNAL_LO counts it down and times out
    at 0. ``table`` is :data:`_NEXT_MODE` flattened, on the tensors' device."""
    lo_t = timer - 1
    new_mode = table[mode.clamp(0, 7).long() * 2 + te.long()]
    new_mode = torch.where((mode == _SIGNAL_LO) & (lo_t == 0), _TIMEOUT, new_mode)
    new_timer = torch.where(mode == _FALL, timeout, torch.where(mode == _SIGNAL_LO, lo_t, timer))
    return new_mode, new_timer


def agc_scan_reference(x, g, y2_prime, alpha, scale, squelch_threshold, locked, squelch_mode,
                       squelch_timer, *, timeout: int):
    """``agc_scan``'s plain version: the loop as torch ops over the time
    axis, one [C] vector per quantity, each op rounded on its own. Same
    arguments and result as :func:`agc_scan_apply`."""
    xr, xi = x.real, x.imag
    g, y2p, mode, timer = g, y2_prime, squelch_mode, squelch_timer
    one_m_alpha = 1.0 - alpha
    neg_half_alpha = -0.5 * alpha
    s = torch.where(locked, 1.0, scale)
    table = torch.tensor(_NEXT_MODE, dtype=torch.int32, device=x.device).flatten()
    yr_all, yi_all = [], []
    for t in range(x.shape[1]):
        yr = xr[:, t] * g
        yi = xi[:, t] * g
        y2 = yr * yr + yi * yi
        y2p = one_m_alpha * y2p + alpha * y2
        g_upd = g * torch.exp(neg_half_alpha * torch.log(torch.clamp(y2p, min=1e-30)))
        g_upd = torch.clamp(torch.where(y2p > 1e-6, g_upd, g), max=1e6)
        g = torch.where(locked, g, g_upd)
        te = -20.0 * torch.log10(g) > squelch_threshold
        mode_new, timer_new = squelch_step(mode, timer, te, timeout, table)
        mode = torch.where(locked, mode, mode_new)
        timer = torch.where(locked, timer, timer_new)
        yr_all.append(yr * s)
        yi_all.append(yi * s)
    y = torch.complex(torch.stack(yr_all, -1), torch.stack(yi_all, -1))
    return y, g, y2p, mode, timer


@trace.kernel
def agc_scan_apply(x, g, y2_prime, alpha, scale, squelch_threshold, locked, squelch_mode,
                   squelch_timer, *, timeout: int):
    """``agc_scan``: the AGC loop over a block, arguments and result as the
    module docstring says.

    CPU tensors run :func:`agc_scan_reference`; CUDA tensors launch the
    kernel (counted in ``agc_scan_apply.launches``) or raise.
    """
    if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError("agc_scan_apply: x must be a [C, n] tensor with C, n >= 1")
    C, n = x.shape
    f32, i32 = torch.float32, torch.int32
    check_tensors("agc_scan_apply", x.device, {
        "x": (x, (C, n), torch.complex64), "g": (g, (C,), f32), "y2_prime": (y2_prime, (C,), f32),
        "alpha": (alpha, (C,), f32), "scale": (scale, (C,), f32),
        "squelch_threshold": (squelch_threshold, (C,), f32), "locked": (locked, (C,), torch.bool),
        "squelch_mode": (squelch_mode, (C,), i32), "squelch_timer": (squelch_timer, (C,), i32),
    })
    if route(x.device, "agc_scan_apply") == "reference":
        return agc_scan_reference(x, g, y2_prime, alpha, scale, squelch_threshold, locked,
                                  squelch_mode, squelch_timer, timeout=timeout)

    from ._build import launch

    y = torch.empty_like(x)
    g_out, y2p_out = torch.empty_like(g), torch.empty_like(y2_prime)
    mode_out, timer_out = torch.empty_like(squelch_mode), torch.empty_like(squelch_timer)
    launch(agc_scan_apply, x.device, "yagi_agc_scan",
           x.data_ptr(), g.data_ptr(), y2_prime.data_ptr(), alpha.data_ptr(), scale.data_ptr(),
           squelch_threshold.data_ptr(), locked.data_ptr(), squelch_mode.data_ptr(),
           squelch_timer.data_ptr(), y.data_ptr(), g_out.data_ptr(), y2p_out.data_ptr(),
           mode_out.data_ptr(), timer_out.data_ptr(), C, n, int(timeout))
    agc_scan_apply.launches += 1
    return y, g_out, y2p_out, mode_out, timer_out
