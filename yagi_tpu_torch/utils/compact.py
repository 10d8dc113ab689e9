"""Valid-prefix compaction of masked emission buffers.

Port of :func:`yagi_tpu.utils.compact.compact_valid`. Feedback loops
(symsync) emit fixed-capacity slot buffers with a validity mask; the public
``execute`` APIs return the valid samples front-compacted with a count. On
the card this is one cumsum and one scatter: each valid entry goes to its
rank among the valid entries, which is exactly stream order, so the result
equals yagi_tpu's stable-sort form bit for bit. (The sort-vs-scatter A/B in
yagi_tpu's docstring is a TPU finding: there a batched scatter lowers to a
serial loop.)
"""

from __future__ import annotations

import torch

__all__ = ["compact_valid"]


def compact_valid(y, v):
    """Front-compact the entries of ``y`` where ``v`` is True (last axis).

    Returns ``(y_compacted, count)``: ``y_compacted[..., :count]`` holds the
    valid entries in stream order and the tail is zero; ``count`` (int64)
    stays on the device.
    """
    n = y.shape[-1]
    vi = v.to(torch.int64)
    count = vi.sum(-1)
    # invalid entries all go to the overflow bin n, which is dropped
    dst = torch.where(v, torch.cumsum(vi, -1) - 1, n)
    out = y.new_zeros(y.shape[:-1] + (n + 1,))
    out.scatter_(-1, dst, y)
    return out[..., :n], count
