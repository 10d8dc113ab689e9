"""Unconjugated inner product (the reference's dotprod trait), on tensors.

Port of :mod:`yagi_tpu.math.dot` (the reference's dotprod/mod.rs:13-17):
sum(a[i]·b[i]) over the last axis with NO conjugation, for every
rrrf/crcf/cccf type combination. yagi_tpu's is ``jnp.sum(a * b, -1)``
outside any kernel, and so is this: the streaming filters never call it.
"""

from __future__ import annotations

import torch

from .._src.device import resolve_device

__all__ = ["dotprod"]


def dotprod(a, b, device=None):
    """sum(a·b) over the last axis, unconjugated (dotprod/mod.rs:13-17).
    Tensors stay on their device; other inputs go to ``resolve_device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=b.device if isinstance(b, torch.Tensor)
                            else resolve_device(device))
    b = torch.as_tensor(b, device=a.device)
    return (a * b).sum(dim=-1)
