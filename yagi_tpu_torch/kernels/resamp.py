"""The arbitrary resampler's u32 PFB step: ``resamp_u32_apply`` (BASELINE
config[1]).

yagi_tpu runs this step in plain XLA (``yagi_tpu/filter/resamp.py``: the u32
schedule, a frame gather [..., cap, L] and one contraction); it wrote no
Pallas kernel for it. In eager torch the same gather writes every output's L
input samples to device memory and reads them back (456 MB at config[1]'s
1024 × 4096 block, about 40 ops), so on the card it is one hand-written
kernel (``csrc/resamp.cu``) that forms each output from the schedule in
registers, beside its plain version :func:`resamp_u32_reference`. Both sum
each output's L products in float32, in two orders.

The schedule is the reference's (resamp.rs:141-154), the same for every
channel: output m has the 64-bit phase P_m = phase + m·step and is emitted
while consuming input n_m = P_m >> 24 through branch
(P_m & 0xffffff) >> (24 − bits); it is valid while n_m < n_valid. So the
valid outputs are a prefix of ``count`` = #{m < cap : n_m < n_valid}, the
carried phase becomes ((phase + count·step) − (n_valid << 24)) mod 2^32, and

    y[..., m] = Σ_l xa[..., n_m + l] · branches[branch_m, L − 1 − l]

with xa = (window[..., 1:], x), samples at or past ``n_valid`` read as 0, and
y = 0 past the count. The new window is the L samples of xa ending at the
last consumed input, or the old window when ``n_valid`` is 0.

Both routes return ``(y, count, new_phase, new_window)``: y [..., cap] with
zeros past the count, the count and the phase 0-d int64 tensors on x's
device (never read back to the host), the window [..., L] in x's dtype. CPU
tensors run the plain version; CUDA tensors launch the kernel (complex64
samples, float32 branches) or raise.
"""

from __future__ import annotations

import math

import torch

from .. import trace
from .._src.struct import U32
from ._check import check_tensors, route

__all__ = ["branch_dots", "resamp_u32_apply", "resamp_u32_reference", "u32_schedule"]

MAX_BITS = 16  # at most 2^16 branches, as Resamp.create allows


def branch_dots(xa: torch.Tensor, branches: torch.Tensor, starts: torch.Tensor,
                branch: torch.Tensor) -> torch.Tensor:
    """One PFB output per (start, branch) pair: [..., len(starts)] with
    y[..., c] = Σ_l xa[..., starts[c] + l] · branches[branch[c], L−1−l], a
    frame gather and one contraction (the resamplers' data-dependent
    emissions, resamp.rs:141-154)."""
    L = branches.shape[1]
    dt = torch.promote_types(xa.dtype, branches.dtype)
    frames = xa[..., starts[:, None] + torch.arange(L, device=xa.device)]  # [..., c, L]
    hb = branches[branch].flip(-1)  # [c, L] oldest..newest
    return torch.einsum("...cl,cl->...c", frames.to(dt), hb.to(dt))


def u32_schedule(phase, step, bits: int, out_capacity: int, consumed):
    """The u32 emission schedule of a block that consumes ``consumed``
    inputs (an int or a 0-d device tensor), from the carried ``phase`` and
    the ``step`` (0-d int64 tensors): (n_m source indices, branch, low 32
    phase bits, valid, num_output, new_phase), each [cap] or 0-d."""
    # one extra index so lo[num_output] is always in range (phase carry)
    m_idx = torch.arange(out_capacity + 1, dtype=torch.int64, device=phase.device)
    acc = phase + m_idx * step  # exact 64-bit phase0 + m·step
    lo_full = acc & U32
    n_m = (acc >> 24)[:out_capacity]  # source sample index
    lo = lo_full[:out_capacity]
    branch = (lo >> (24 - bits)) & ((1 << bits) - 1)
    valid = n_m < consumed
    num_output = valid.sum()
    # phase' = (phase + num_output·step) - consumed·2^24 (mod 2^32),
    # resamp.rs:149-151; a gather, not lo_full[num_output], which would
    # read the count back to the host
    lo_out = lo_full.gather(0, num_output.reshape(1))[0]
    new_phase = (lo_out - ((consumed & 0xFF) << 24)) & U32
    return n_m, branch, lo, valid, num_output, new_phase


def resamp_u32_reference(x, window, branches, phase, step, n_valid, *, out_capacity: int):
    """``resamp_u32_apply``'s plain version, the torch ops of the u32 PFB
    gather: the masked block after the window's L − 1 newest samples, the
    schedule, a frame gather [..., cap, L] (counted: ``resamp.frame_bytes``,
    the bytes it writes) and one contraction, the new window by a gather."""
    n = x.shape[-1]
    dev = x.device
    L = branches.shape[1]
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=dev).clamp(0, n)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    x = torch.where(torch.arange(n, device=dev) < n_valid, x, zero)
    xa = torch.cat([window[..., 1:].to(x.dtype), x], dim=-1)
    n_m, branch, _, valid, num_output, new_phase = u32_schedule(
        phase, step, branches.shape[0].bit_length() - 1, out_capacity, n_valid)
    trace.count("resamp.frame_bytes", math.prod(xa.shape[:-1]) * out_capacity * L
                * xa.element_size())
    y = branch_dots(xa, branches, n_m.clamp(0, n - 1), branch)
    y = torch.where(valid, y, zero)
    # the L samples ending at the last valid one; the old window if none
    start = (n_valid - 1).clamp(0, n - 1)
    sliced = xa[..., start + torch.arange(L, device=dev)]
    new_window = torch.where(n_valid > 0, sliced, window.to(x.dtype))
    return y, num_output, new_phase, new_window


def _check(x, window, branches, phase, step, n_valid, out_capacity) -> None:
    """Shapes, dtypes and devices both routes need; contiguity and the
    card's dtypes are the kernel route's own checks."""
    fn = "resamp_u32_apply"
    if not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"{fn}: x must be a tensor [..., n] with n >= 1")
    if not isinstance(branches, torch.Tensor) or branches.dim() != 2:
        raise ValueError(f"{fn}: branches must be a [npfb, L] tensor")
    npfb, L = branches.shape
    if L < 1 or npfb < 2 or npfb > 1 << MAX_BITS or npfb & (npfb - 1):
        raise ValueError(f"{fn}: branches [{npfb}, {L}]: npfb must be a power of two in "
                         f"[2, 2^{MAX_BITS}] and L >= 1")
    if isinstance(out_capacity, bool) or not isinstance(out_capacity, int) or out_capacity < 1:
        raise ValueError(f"{fn}: out_capacity must be a positive int")
    n = x.shape[-1]
    if not isinstance(n_valid, torch.Tensor) and (
            isinstance(n_valid, bool) or not isinstance(n_valid, int) or not 0 <= n_valid <= n):
        raise ValueError(f"{fn}: n_valid must be an int in [0, {n}] or a 0-d int64 tensor")
    shapes = {"window": (window, x.shape[:-1] + (L,)), "phase": (phase, ()), "step": (step, ())}
    if isinstance(n_valid, torch.Tensor):
        shapes["n_valid"] = (n_valid, ())
    for name, (t, shape) in shapes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: {name} must be a tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.device != x.device or branches.device != x.device:
            raise ValueError(f"{fn}: {name} and branches must be on x's device {x.device}")
        if name != "window" and t.dtype != torch.int64:
            raise TypeError(f"{fn}: {name} must be torch.int64, got {t.dtype}")


@trace.kernel
def resamp_u32_apply(x, window, branches, phase, step, n_valid, *, out_capacity: int):
    """The u32 PFB resampler over one block: ``x`` [..., n] after the PFB
    ``window`` [..., L], ``branches`` [npfb, L] (convolution order, npfb a
    power of two), the carried ``phase`` and the ``step`` (0-d int64 tensors
    holding u32 values), of which the first ``n_valid`` samples are consumed
    (an int in [0, n], or a 0-d int64 tensor on x's device, never read back,
    that both routes clamp to [0, n]). Returns
    ``(y [..., out_capacity], count, new_phase, new_window)`` as the module
    docstring says. Counted: ``resamp.calls``, every call on either route.

    CPU tensors run :func:`resamp_u32_reference`; CUDA tensors launch
    ``csrc/resamp.cu`` (counted in ``resamp_u32_apply.launches``) on
    complex64 samples and float32 branches, or raise.
    """
    _check(x, window, branches, phase, step, n_valid, out_capacity)
    trace.count("resamp.calls")
    if route(x.device, "resamp_u32_apply") == "reference":
        return resamp_u32_reference(x, window, branches, phase, step, n_valid,
                                    out_capacity=out_capacity)

    from ._build import launch

    fn = "resamp_u32_apply"
    npfb, L = branches.shape
    batch, n = x.shape[:-1], x.shape[-1]
    C = math.prod(batch)
    x, window = x.contiguous(), window.to(x.dtype).contiguous()
    check_tensors(fn, x.device, {
        "x": (x, x.shape, torch.complex64), "window": (window, window.shape, torch.complex64),
        "branches": (branches, (npfb, L), torch.float32),
    })
    if C < 1 or C >= 1 << 31 or n >= 1 << 31 or out_capacity >= 1 << 31:
        raise ValueError(f"{fn}: [{C}, {n}] → {out_capacity} outputs is past the kernel's "
                         "index range")
    dev = x.device
    y = torch.empty(batch + (out_capacity,), dtype=torch.complex64, device=dev)
    new_window = torch.empty(batch + (L,), dtype=torch.complex64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    new_phase = torch.empty((), dtype=torch.int64, device=dev)
    nv_ptr, nv = (n_valid.data_ptr(), 0) if isinstance(n_valid, torch.Tensor) else (None, n_valid)
    launch(resamp_u32_apply, dev, "yagi_resamp_u32",
           x.data_ptr(), window.data_ptr(), branches.data_ptr(), phase.data_ptr(),
           step.data_ptr(), nv_ptr, y.data_ptr(), new_window.data_ptr(), count.data_ptr(),
           new_phase.data_ptr(), C, n, out_capacity, L, npfb, nv)
    resamp_u32_apply.launches += 1
    return y, count, new_phase, new_window
