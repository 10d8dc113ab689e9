"""Complex elementwise math on tensors.

Port of :mod:`yagi_tpu.math.complexm` (the reference's math/complex.rs,
liquid's cexpf/clogf/csqrtf/casinf/cacosf/catanf), which evaluates NumPy's
ufuncs in complex128. Here each function evaluates in complex128 and
returns the input's complex precision: complex64 for complex64 or float32
input, within one ulp of yagi_tpu's value.
"""

from __future__ import annotations

import torch

from .._src.device import resolve_device

__all__ = ["cexpf", "clogf", "csqrtf", "casinf", "cacosf", "catanf"]


def _apply(fn, z, device):
    """``fn`` of ``z`` in complex128, returned in z's complex precision; a
    tensor stays on its device, anything else goes to ``resolve_device``."""
    if not isinstance(z, torch.Tensor):
        z = torch.as_tensor(z, device=resolve_device(device))
    out = torch.complex128 if z.dtype in (torch.float64, torch.complex128) else torch.complex64
    return fn(z.to(torch.complex128)).to(out)


def cexpf(z, device=None):
    return _apply(torch.exp, z, device)


def clogf(z, device=None):
    return _apply(torch.log, z, device)


def csqrtf(z, device=None):
    return _apply(torch.sqrt, z, device)


def casinf(z, device=None):
    return _apply(torch.asin, z, device)


def cacosf(z, device=None):
    return _apply(torch.acos, z, device)


def catanf(z, device=None):
    return _apply(torch.atan, z, device)
