"""Statistics of a run: percentiles, unions of intervals and the gaps
between them, and the bound of a kernel's work."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q% of ``values`` at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def covered(intervals, lo: float, hi: float) -> float:
    """The length of ``[lo, hi]`` that the union of ``intervals`` covers."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals):
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def bound_s(work: tuple[float, float], peaks: dict) -> float:
    """The least time in seconds a device with ``peaks`` takes for
    ``(bytes, operations)``: each byte once at the memory rate, or the
    operations at the fp32 rate, whichever is longer."""
    nbytes, ops = work
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops_per_s"])
