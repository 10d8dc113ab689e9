"""How the FFT layer takes its input: a tensor where it lies, anything else
on the card unless the caller names a device."""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device


def as_signal(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is, anything else goes to
    ``device`` (the card by default); float64 and complex128 become float32
    and complex64."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    if x.dtype == torch.float64:
        return x.float()
    if x.dtype == torch.complex128:
        return x.to(torch.complex64)
    return x
