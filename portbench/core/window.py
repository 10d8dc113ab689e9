"""The measured window: blocks streamed back to back through the entry,
the state threaded from block to block, two blocks (``in_flight``) on the
device at a time.

Before block i is handed over the host waits on the event recorded after
block i − in_flight. A block's latency runs from its hand-over to the moment
the host saw its event complete. Outputs stay on the device; the window ends
in a synchronize. With ``trace_steps``, that many steps are profiled
(:mod:`torch.profiler`) once half the window has passed: the blocks in
flight are drained, the profiler starts, ``PRIME_STEPS`` steps run and are
drained, then the slice's steps run, and the slice ends in a synchronize.
"""

from __future__ import annotations

import contextlib
import random
import time
from collections import deque
from dataclasses import dataclass, field

import torch

ENTRY, WAIT, SYNC = "portbench.entry", "portbench.wait", "portbench.sync"
PRIME = "portbench.prime"
# steps run under the profiler before its slice: the first launches after it
# starts wait on its set-up, which is no idle time of the program
PRIME_STEPS = 2


class _HostEvent:
    """A stand-in for a CUDA event where the device is the CPU: its work is
    done when the call returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


class Device:
    """The device the cell runs on: events, synchronize, memory, name."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def event(self):
        return torch.cuda.Event() if self.cuda else _HostEvent()

    def synchronize(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def kind(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.cuda else "cpu"


@dataclass
class Kept:
    """One block kept for the check: its index in the stream, the state the
    entry got, what it returned and the state it returned."""

    index: int
    before: object
    out: object
    after: object


class Keeper:
    """A uniform sample of ``k`` window blocks drawn from ``seed``
    (reservoir sampling: the window's length is not known in advance).
    Kept outputs are held, not copied."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept: list[Kept] = []

    def offer(self, index, before, out, after) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(Kept(index, before, out, after))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = Kept(index, before, out, after)


@dataclass
class Window:
    """What the window measured. Times in seconds on the host clock."""

    first: int  # stream index of the first window block
    blocks: int = 0
    seconds: float = 0.0
    latencies: list = field(default_factory=list)  # per block, hand-over to seen complete
    host_entry: float = 0.0  # seconds inside the entry call, outside the traced slice
    host_steps: int = 0  # steps those seconds cover
    trace: object = None  # the profiler of the traced slice
    trace_steps: int = 0
    state: object = None  # the state after the last block


def run(step, state, blocks, first: int, seconds: float, dev: Device, keeper: Keeper | None,
        in_flight: int = 2, trace_steps: int = 0) -> Window:
    """Stream ``blocks`` (cycled, starting at stream index ``first``)
    through ``step(state, block) -> (out, state)`` for ``seconds``."""
    n_cycle = len(blocks)
    events = [dev.event() for _ in range(in_flight + 1)]
    pending: deque = deque()
    hand: dict = {}
    win = Window(first=first)
    prof, sliced, slice_first = None, False, 0
    span = contextlib.nullcontext

    def wait_one():
        j, ev = pending.popleft()
        with span(WAIT):
            ev.synchronize()
        win.latencies.append(time.perf_counter() - hand.pop(j))

    i = first
    t0 = time.perf_counter()
    while True:
        while len(pending) >= in_flight:
            wait_one()
        now = time.perf_counter()
        if trace_steps and not sliced and prof is None and now - t0 >= 0.5 * seconds:
            while pending:
                wait_one()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA]
                                             if dev.cuda else []))
            prof.start()
            span, slice_first = torch.profiler.record_function, None
            prime_end = i + PRIME_STEPS
        if prof is not None and slice_first is None and i == prime_end:
            while pending:
                wait_one()
            slice_first = i
        if prof is not None and slice_first is not None and i - slice_first == trace_steps:
            while pending:
                wait_one()
            with span(SYNC):
                dev.synchronize()
            prof.stop()
            win.trace, win.trace_steps = prof, trace_steps
            prof, sliced, span = None, True, contextlib.nullcontext
            now = time.perf_counter()
        if now - t0 >= seconds and prof is None:
            break
        x = blocks[i % n_cycle]
        t_hand = time.perf_counter()
        with span(ENTRY if slice_first is not None else PRIME):
            out, new = step(state, x)
        t_back = time.perf_counter()
        if prof is None:
            win.host_entry += t_back - t_hand
            win.host_steps += 1
        ev = events[i % len(events)]
        ev.record()
        pending.append((i, ev))
        hand[i] = t_hand
        if keeper is not None:
            keeper.offer(i, state, out, new)
        state = new
        del out
        i += 1
    while pending:
        wait_one()
    dev.synchronize()
    win.seconds = time.perf_counter() - t0
    win.blocks = i - first
    win.state = state
    return win
