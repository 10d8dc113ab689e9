"""Where the port's objects are built: the card unless the caller asks.

Every factory (``create*``) and :func:`~yagi_tpu_torch._src.struct.load_state`
passes its ``device`` argument through :func:`resolve_device`. ``None``
means the current CUDA device; with no card it raises
:class:`~yagi_tpu_torch.errors.DeviceError`, never a silent move to the CPU.
The kernel wrappers (``kernels/*_apply``) do not come here: they route by
the device of the tensors they are given (``kernels/_check.py``).

The first resolve of each CUDA device in a process makes the card's context
(``torch.cuda.init()``, then a synchronize of the device) inside the set-up
span ``yagi.device``, so that its seconds are not counted to whichever
factory or tensor first touches the card. The entries' ``create`` take
:func:`resolves_device`, which resolves the device before their own span
opens.
"""

from __future__ import annotations

import functools
import inspect
import threading

import torch

from .. import trace
from ..errors import DeviceError

_opened: set[int] = set()  # the CUDA devices whose context this process has made
_open_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is the current CUDA
    device, and raises :class:`DeviceError` when torch sees no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device: the port builds its objects on the card by default; "
                "pass device='cpu' to build them on the CPU"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(device)
    if device.type == "cuda":
        _open(torch.cuda.current_device() if device.index is None else device.index)
    return device


def _open(index: int) -> None:
    """Make device ``index``'s context, once a process, inside ``yagi.device``."""
    if index in _opened:
        return
    with _open_lock:
        if index in _opened:
            return
        with trace.span("yagi.device", always=True):
            torch.cuda.init()
            torch.cuda.synchronize(index)
        _opened.add(index)


def resolves_device(factory):
    """Decorator: the factory's ``device`` argument passes through
    :func:`resolve_device` before the call, outside the factory's own spans."""
    sig = inspect.signature(factory)

    @functools.wraps(factory)
    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.arguments["device"] = resolve_device(bound.arguments.get("device"))
        return factory(*bound.args, **bound.kwargs)

    return call
