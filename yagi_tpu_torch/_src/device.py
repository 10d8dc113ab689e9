"""Where the port's objects are built: the card unless the caller asks.

Every factory (``create*``) and :func:`~yagi_tpu_torch._src.struct.load_state`
passes its ``device`` argument through :func:`resolve_device`. ``None``
means the current CUDA device; with no card it raises
:class:`~yagi_tpu_torch.errors.DeviceError`, never a silent move to the CPU.
The kernel wrappers (``kernels/*_apply``) do not come here: they route by
the device of the tensors they are given (``kernels/_check.py``).
"""

from __future__ import annotations

import torch

from ..errors import DeviceError


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is the current CUDA
    device, and raises :class:`DeviceError` when torch sees no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device: the port builds its objects on the card by default; "
            "pass device='cpu' to build them on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
