"""Argument checks and device routing shared by the kernel wrappers."""

from __future__ import annotations

import torch


def route(device: torch.device, fn: str) -> str:
    """Which implementation of ``fn`` serves tensors on ``device``: ``"cuda"``
    (the kernel) or ``"reference"`` (plain torch, CPU only)."""
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "reference"
    raise ValueError(f"{fn}: no implementation for device {device}")


def check_tensors(fn: str, device: torch.device, specs: dict) -> None:
    """Raise unless each argument is a contiguous tensor of its shape and
    dtype on ``device``. ``specs`` maps a name to ``(value, shape, dtype)``."""
    for name, (t, shape, dtype) in specs.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: {name} must be a tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (a
    kernel that copies 16-byte chunks needs the start aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
