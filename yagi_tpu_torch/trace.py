"""The port's own tracing: spans and counters at its layer boundaries.

Off by default, and then a span site costs one flag check: no clock read, no
allocation, no torch call. ``enable()`` turns it on for the process; from
then on every span adds its time on the host clock (``time.perf_counter_ns``,
CLOCK_MONOTONIC on Linux) to running totals by name, and :func:`snapshot`
returns them as plain numbers::

    from yagi_tpu_torch import trace

    trace.enable()
    for x in blocks:
        y, _, chain = chain.step(x)
    totals = trace.snapshot()["spans"]["yagi.rxchain.step"]  # count, ns, self_ns

A span's self time is its time less the time of the spans opened inside it
on the same thread (each thread keeps its own stack of open spans). Spans
keep their times on the host clock only: they open no profiler range and add
no device operation, host-device sync or tensor allocation, so a profiler's
trace reads the same with tracing on or off.

Each timed span is also kept as an interval ``(name, start_ns, end_ns)`` on
that clock, the process's timeline: the set-up spans (below) always, a
handful a process; the others only while tracing is on, the newest
:data:`STEP_INTERVALS` of them, those pushed out counted as dropped. The
module's import takes one anchor, ``time.time_ns()`` beside
``time.perf_counter_ns()``, which puts the intervals on the wall clock (the
one a process's start time in ``/proc`` is read on) or on a profiler's.

Every name starts with ``yagi.``:

- entries: ``yagi.rxchain.step`` (``FusedRxChain.step``, ``step_planar``)
  over ``yagi.rxchain.advance`` (the state's update); ``yagi.qamrx.step``
  (``QamRx.step_masked``) over ``yagi.agc.run`` (``Agc._run``),
  ``yagi.symsync.run`` (``Symsync._run_slots``), ``yagi.qamrx.eq`` (the
  equalizer's arguments and scan) and ``yagi.qamrx.state`` (the new state);
  ``yagi.chzfm.step`` (``ChannelizerFmRx.step``) over ``yagi.chzfm.channelize``
  (the one call of ``fused_channelizer_apply`` with its FM argument, whose
  kernel span holds, on the two-step routes alone, the CPU's and that past
  64 taps a branch, ``yagi.chzfm.demod``: the plain discriminator and the
  state's copies after the channelizer; on the card up to 64 taps the FM
  instance's one launch writes it all) and ``yagi.chzfm.state`` (the new
  state); ``yagi.symrx.step`` (``ResampSymsyncRx.step``, ``step_full``)
  over ``yagi.symrx.resamp`` (the whole ``MsResamp.execute_block``),
  ``yagi.symsync.run`` and ``yagi.symrx.state`` (the new state);
  ``yagi.fmrx.step`` (``FmStereoRx.step``) over ``yagi.fmrx.demod`` (the
  discriminator), ``yagi.fmrx.pilot`` (the pilot's bandpass FIR and the
  subcarrier), ``yagi.fmrx.fir`` (the delay and the two audio FIRs),
  ``yagi.fmrx.deemph`` (the two de-emphasis blocks, over their
  ``yagi.kernel.iir_chunked_apply``) and ``yagi.fmrx.state`` (the new state);
- kernel wrappers (the twelve registered by :func:`kernel`):
  ``yagi.kernel.<wrapper>`` around the checks, routing and allocations, over
  ``yagi.kernel.<wrapper>.launch`` around the stream fetch and the call into
  the kernels' library;
- set-up: ``yagi.device`` (``_src/device.py::resolve_device``: the first
  resolve of a CUDA device in the process, which makes the card's context;
  none on the CPU), ``yagi.library`` (the kernels' library found, built or
  loaded, and bound: its first use), ``yagi.rxchain.create`` over
  ``yagi.rxchain.taps`` (the compact taps' round trip to host numpy),
  ``yagi.qamrx.create``, ``yagi.chzfm.create``, ``yagi.symrx.create``,
  ``yagi.fmrx.create`` (each entry's device resolved before its span opens),
  and ``yagi.<entry>.first_step`` over the entry's first step in the process
  (``rxchain``, ``qamrx``, ``chzfm``, ``symrx``, ``fmrx``: each kernel's
  first launch, the caching allocator's first segments, the library's first
  use if ``create`` did not make it). These are timed whether tracing is on
  or off (``always=True``, ``first=``): each runs once for an object or a
  process, and two clock reads are nothing beside the designs, builds and
  first launches they time. A later step pays one set lookup for its
  ``first``, and no clock read.

Counters count whether tracing is on or off: ``library.builds`` (nvcc runs of
the kernels' library), ``qam_eq_scan.slots`` (the slots ``qam_eq_scan_apply``
hands to the kernel's register instance), ``symsync_fused.slots`` (the C·n·E
slots ``symsync_fused_apply`` hands to K3), ``channelizer.fm_epilogue`` (the
launches of K2's FM instance, the channelizer with the discriminator in its
epilogue), ``resamp.calls`` (the calls of ``resamp_u32_apply``, the u32
PFB resampler, on either route) and ``resamp.frame_bytes`` (the bytes of the
frames [..., cap, L] its plain version's gather writes to device memory,
C·cap·L·itemsize; the kernel writes none), the FIRs'
``conv.frame_bytes``, ``conv.macs`` and ``conv.tap_macs``: on the banded
matmul (``filter/_conv.py``: ``causal_conv_valid``, its strided form and
``multi_branch_conv``, each real half of a complex signal through real taps
alone; ``fir_block_apply``'s plain version) the frames [B, nb, K] a call
writes (B·nb·K·itemsize), the multiply-adds its matmul runs (B·nb·128·K a
filter) and those the filter needs (B·n_out·L), complex products counted as
4 real; on ``fir_block_apply``'s kernel (``csrc/fir.cu``, direct form) 0
bytes of frames and B·n·L·r multiply-adds in both, r = 1, 2 or 4 the real
multiply-adds a tap of its types; ``fmrx.steps`` (the calls
of ``FmStereoRx.step``, over which a step's share of those is read), and
each registered kernel wrapper's launches, in its ``launches`` attribute,
which :func:`launches` reads. A kernel can count on the device too, into a :func:`device_counter`:
``qam_eq_scan.rounds`` (the rounds that instance ran, summed over channels),
``symsync_fused.chain_slots`` (the slots K3 ran its chain for, summed over
channels).
:func:`snapshot` reads those, and only it does, so a step adds no sync.
"""

from __future__ import annotations

import collections
import functools
import threading
import time

__all__ = ["PREFIX", "STEP_INTERVALS", "count", "device_counter", "enable", "kernel",
           "launches", "reset", "snapshot", "span", "spanned"]

PREFIX = "yagi."
STEP_INTERVALS = 65_536  # the newest intervals of spans other than set-up's that are kept

_on = False
_clock = time.perf_counter_ns
_ANCHOR = (time.time_ns(), time.perf_counter_ns())  # (wall ns, clock ns) at one moment
_spans: dict[str, list[int]] = {}  # name -> [count, ns, self ns]
_setup: list[tuple[str, int, int]] = []  # the set-up spans' intervals, in closing order
_steps: collections.deque = collections.deque(maxlen=STEP_INTERVALS)  # the others'
_dropped = 0  # intervals pushed out of _steps
_firsts: set[str] = set()  # the ``first`` spans this process has taken
_first_lock = threading.Lock()
_counters: dict[str, int] = {}
_device_counters: dict[str, dict] = {}  # name -> {device: int64 tensor of one element}
_local = threading.local()  # .stack: this thread's open spans, innermost last
_kernels: list = []  # the registered kernel wrappers


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    """The one span every site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "setup", "t0", "child_ns", "stack")

    def __init__(self, name: str, setup: bool = False):
        self.name = name
        self.setup = setup

    def __enter__(self):
        self.child_ns = 0
        self.stack = _stack()
        self.stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = _clock()
        ns = t1 - self.t0
        if self.setup:
            _setup.append((self.name, self.t0, t1))
        else:
            if len(_steps) == _steps.maxlen:
                _dropped += 1
            _steps.append((self.name, self.t0, t1))
        stack = self.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += ns
        total = _spans.get(self.name)
        if total is None:
            total = _spans[self.name] = [0, 0, 0]
        total[0] += 1
        total[1] += ns
        total[2] += ns - self.child_ns
        return False


def enable(on: bool = True) -> None:
    """Turn tracing on (or off) for the process. The totals stay; see :func:`reset`."""
    global _on
    _on = bool(on)


def reset() -> None:
    """Clear the span totals, the timeline and the counters, the device's
    too (not the kernels' launches, nor which ``first`` spans were taken:
    each stays the process's first)."""
    global _dropped
    _spans.clear()
    _setup.clear()
    _steps.clear()
    _dropped = 0
    _counters.clear()
    for per in _device_counters.values():
        for t in per.values():
            t.zero_()


def span(name: str, always: bool = False):
    """A context manager that adds the time inside it to span ``name``
    while tracing is on, or with ``always`` (set-up work) in any case."""
    return _Span(name, always) if _on or always else _OFF


def _take(first: str) -> bool:
    """Whether this call takes ``first``: true once a process."""
    with _first_lock:
        if first in _firsts:
            return False
        _firsts.add(first)
        return True


def spanned(name: str, always: bool = False, first: str | None = None):
    """Decorator: each call of the function runs inside ``span(name, always)``;
    with ``first``, the process's first call of any function that names it
    also runs inside the set-up span ``first``, around the other."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_on or always):
                return fn(*args, **kwargs)
            with _Span(name, always):
                return fn(*args, **kwargs)

        if first is None:
            return call

        @functools.wraps(fn)
        def call_first(*args, **kwargs):
            if first not in _firsts and _take(first):
                with _Span(first, True):
                    return call(*args, **kwargs)
            if not (_on or always):
                return fn(*args, **kwargs)
            with _Span(name, always):
                return fn(*args, **kwargs)

        return call_first

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def device_counter(name: str, device):
    """Counter ``name`` on ``device``: an int64 tensor of one element, made
    (zero) at the first call for a name and device, that a kernel adds to."""
    per = _device_counters.setdefault(name, {})
    t = per.get(device)
    if t is None:
        import torch

        t = per[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return t


def kernel(fn):
    """Register a kernel wrapper. Each call runs inside span
    ``yagi.kernel.<name>``; ``fn.launch_span`` names its launch's span and
    ``fn.launches`` counts its launches (the wrapper adds to it)."""
    name = f"{PREFIX}kernel.{fn.__name__}"
    wrapper = spanned(name)(fn)
    wrapper.launch_span = f"{name}.launch"
    wrapper.launches = 0
    _kernels.append(wrapper)
    return wrapper


def launches() -> dict[str, int]:
    """Each kernel wrapper's launches in this process, by name."""
    from . import kernels  # noqa: F401  (importing it registers every wrapper)

    return {k.__name__: k.launches for k in _kernels}


def snapshot() -> dict:
    """The totals so far as plain numbers: ``spans`` (name -> count, ns,
    self_ns), ``counters`` (the device counters summed over devices, read
    here: a sync of each device that has one), ``launches`` (name -> count)
    and ``timeline``: ``anchor`` (``wall_ns`` and ``clock_ns`` read at one
    moment), ``setup`` and ``steps`` (intervals ``(name, start_ns, end_ns)``
    on the spans' clock, each list by start) and ``dropped`` (step intervals
    pushed out of the bounded buffer)."""
    counters = dict(_counters)
    for name, per in _device_counters.items():
        counters[name] = counters.get(name, 0) + sum(int(t.item()) for t in per.values())
    by_start = functools.partial(sorted, key=lambda iv: iv[1])
    return {
        "spans": {n: {"count": c, "ns": ns, "self_ns": s} for n, (c, ns, s) in _spans.items()},
        "counters": counters,
        "launches": launches(),
        "timeline": {"anchor": {"wall_ns": _ANCHOR[0], "clock_ns": _ANCHOR[1]},
                     "setup": by_start(_setup), "steps": by_start(_steps),
                     "dropped": _dropped},
    }
