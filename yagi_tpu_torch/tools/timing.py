"""Device time of calls on the card, between CUDA events."""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` in ms over ``iters`` eager calls, between
    CUDA events: device time, or host time where launching is the slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int = 10) -> float:
    """Mean device time per call in ms: the calls ``fns`` are captured once
    into a CUDA graph, which is replayed ``reps`` times, so host launch cost
    is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))
