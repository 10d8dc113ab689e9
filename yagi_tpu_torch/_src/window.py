"""The carried windows of the streaming objects, safe for empty blocks.

A streaming object keeps the newest L samples of its input and filters
``xa = concat(window[..., d:], x)`` (d = 0 or 1 carried samples dropped).
yagi_tpu takes the new window as ``xa[..., xa.shape[-1] - L:]``; on a block
of 0 samples with d = 1 the start is −1 and the slice keeps one sample, so
the next block breaks the carry contract. :func:`carry` keeps the window
when the block is empty, and :func:`last` keeps a last-sample state.
"""

from __future__ import annotations

import torch


def carry(window: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
    """The window after a block: the last ``window.shape[-1]`` samples of
    ``xa``, the stream from at most one sample into ``window`` through the
    block. Shorter than the window only when the block was empty: then the
    window stands, in ``xa``'s dtype."""
    L = window.shape[-1]
    if xa.shape[-1] < L:
        return window.to(xa.dtype)
    return xa[..., xa.shape[-1] - L :]


def last(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """``x[..., -1]``, or ``prev`` when the block ``x`` has no samples."""
    return x[..., -1] if x.shape[-1] else prev
