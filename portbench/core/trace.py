"""The traced slice read from the profiler: device operations with their
times, the harness's host spans, and what follows from them (busy time,
idle gaps by host span, device time by operation)."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass

from torch.autograd import DeviceType

from . import stats
from .window import ENTRY, PRIME, SYNC, WAIT

_NAME_CHARS = 120  # device op names in the breakdown are cut to this length


@dataclass
class Op:
    name: str
    start: float  # seconds on the profiler's clock
    end: float


@dataclass
class Slice:
    """The traced slice: ``ops`` on the device, ``spans`` of the harness on
    the host (name, start, end), over ``[lo, hi]``, ``steps`` steps."""

    ops: list
    spans: list
    lo: float
    hi: float
    steps: int

    @property
    def wall_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return stats.covered([(o.start, o.end) for o in self.ops], self.lo, self.hi)

    def matching(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o.name)]

    def by_name(self) -> list[tuple[str, float]]:
        """Device seconds by operation name, most first."""
        total = defaultdict(float)
        for o in self.ops:
            total[o.name] += o.end - o.start
        return sorted(total.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Every stretch with no device operation, named by the harness span
        the host spent most of it in (``entry``: in the entry call; ``wait``:
        waiting on a block's event; ``harness``: neither), longest first."""
        gaps = stats.gaps([(o.start, o.end) for o in self.ops], self.lo, self.hi)
        names = {ENTRY: "entry", WAIT: "wait", SYNC: "wait"}
        out = []
        for a, b in gaps:
            inside = {"entry": 0.0, "wait": 0.0}
            for name, s, e in self.spans:
                inside[names[name]] += max(0.0, min(b, e) - max(a, s))
            label = max(inside, key=inside.get)
            if inside[label] < 0.5 * (b - a):
                label = "harness"
            out.append((label, b - a))
        return sorted(out, key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:_NAME_CHARS], s] for n, s in self.by_name()[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:10]]}


def read(prof, steps: int) -> Slice:
    """The slice a :func:`portbench.core.window.run` profiled."""
    ops, spans = [], []
    for e in prof.events():
        t = e.time_range
        if e.name in (ENTRY, WAIT, SYNC, PRIME):  # the harness's spans; on the device, annotations
            if e.device_type == DeviceType.CPU and e.name != PRIME:
                spans.append((e.name, t.start * 1e-6, t.end * 1e-6))
        elif e.device_type == DeviceType.CUDA:
            ops.append(Op(e.name, t.start * 1e-6, t.end * 1e-6))
    entries = [s for s in spans if s[0] == ENTRY]
    lo = min((s[1] for s in entries), default=0.0)
    ops = [o for o in ops if o.end > lo]  # the primed steps' operations end before the slice
    syncs = [s for s in spans if s[0] == SYNC]
    hi = max(s[2] for s in syncs) if syncs else max((o.end for o in ops), default=lo)
    return Slice(ops=ops, spans=sorted(spans, key=lambda s: s[1]), lo=lo, hi=hi, steps=steps)
