"""u32 NCO mix-down kernel: y[t] = x[t]·e^{−j(θ0 + t·dθ)}.

Port of :func:`yagi_tpu.kernels.mix.pallas_mix_down`, with the oscillator's
exact wrapping u32 phase (osc.rs:86-88,191-200). Two implementations of one
function, chosen by the device of the input:

* :func:`mix_down_reference`, plain torch, equal to ``Osc.mix_block_down``
  in mode "exact". CPU tensors run it.
* ``csrc/mix.cu``, the hand-written Hopper kernel, which replaces
  ``yagi_tpu/kernels/mix.py::_mix_kernel``. CUDA tensors run it, or the call
  raises; nothing falls back.

Complex I/O is interleaved complex64, as the TPU wrapper's interface is.
"""

from __future__ import annotations

import torch

from .. import trace
from .._src.struct import U32
from ..nco.osc import _rotate_down
from ._check import check_tensors, route

__all__ = ["mix_down_apply", "mix_down_reference"]

_TILE = 256 * 128  # the TPU kernel's tile; block lengths stay multiples of it


def mix_down_reference(x, theta0, dtheta):
    """Plain-torch mix-down: x [N] complex64 times e^{−jθ[t]}, with
    θ[t] = θ0 + t·dθ wrapping in u32 (0-d int64 tensors)."""
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return _rotate_down(x, (theta0 + idx * dtheta) & U32)


def _check(x, theta0, dtheta) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != 1:
        raise ValueError("mix_down_apply: x must be a 1-d tensor")
    n = x.shape[0]
    if n == 0 or n % _TILE:
        raise ValueError(f"length must be a positive multiple of {_TILE}")
    check_tensors("mix_down_apply", x.device, {
        "x": (x, (n,), torch.complex64),
        "theta0": (theta0, (), torch.int64), "dtheta": (dtheta, (), torch.int64),
    })


@trace.kernel
def mix_down_apply(x, theta0, dtheta):
    """Mix x [N] (complex64, N a multiple of 32768) down by the u32 NCO.

    theta0/dtheta: 0-d int64 tensors holding the u32 phase and frequency, on
    x's device, so nothing waits on the host. Returns x·e^{−jθ[t]} as
    ``Osc.mix_block_down`` in mode "exact" does; the caller advances the
    phase, θ0' = θ0 + N·dθ mod 2^32. The counterpart of
    ``yagi_tpu/kernels/mix.py::pallas_mix_down``.

    CPU tensors run :func:`mix_down_reference`; CUDA tensors launch the kernel
    (counted in ``mix_down_apply.launches``) or raise.
    """
    _check(x, theta0, dtheta)
    if route(x.device, "mix_down_apply") == "reference":
        return mix_down_reference(x, theta0, dtheta)

    from ._build import launch

    n = x.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"length {n} exceeds the kernel's index range")
    if x.data_ptr() % 16:
        raise ValueError("mix_down_apply: x must be 16-byte aligned")
    y = torch.empty_like(x)
    launch(mix_down_apply, x.device, "yagi_mix_down",
           x.data_ptr(), theta0.data_ptr(), dtheta.data_ptr(), y.data_ptr(), n)
    mix_down_apply.launches += 1
    return y
