"""The port's own tracing: spans and counters at its layer boundaries.

Off by default, and then a span site costs one flag check: no clock read, no
allocation, no torch call. ``enable()`` turns it on for the process; from
then on every span adds its time on the host clock (``time.perf_counter_ns``)
to running totals by name, and :func:`snapshot` returns them as plain numbers::

    from yagi_tpu_torch import trace

    trace.enable()
    for x in blocks:
        y, _, chain = chain.step(x)
    totals = trace.snapshot()["spans"]["yagi.rxchain.step"]  # count, ns, self_ns

A span's self time is its time less the time of the spans opened inside it
on the same thread (each thread keeps its own stack of open spans). Spans
keep totals on the host clock only: they open no profiler range and add no
device operation, host-device sync or tensor allocation, so a profiler's
trace reads the same with tracing on or off.

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
  state);
- kernel wrappers (the ten registered by :func:`kernel`):
  ``yagi.kernel.<wrapper>`` around the checks, routing and allocations, over
  ``yagi.kernel.<wrapper>.launch`` around the stream fetch and the call into
  the kernels' library;
- set-up: ``yagi.library`` (the kernels' library found, built or loaded,
  and bound: its first use), ``yagi.rxchain.create`` over
  ``yagi.rxchain.taps`` (the compact taps' round trip to host numpy),
  ``yagi.qamrx.create``, ``yagi.chzfm.create``. These are timed whether
  tracing is on or off (``always=True``): each runs once for an object or a
  process, and two clock reads are nothing beside the designs and builds
  they time.

Counters count whether tracing is on or off: ``library.builds`` (nvcc runs of
the kernels' library), ``qam_eq_scan.slots`` (the slots ``qam_eq_scan_apply``
hands to the kernel's register instance), ``channelizer.fm_epilogue`` (the
launches of K2's FM instance, the channelizer with the discriminator in its
epilogue), and each registered kernel
wrapper's launches, in its ``launches`` attribute, which :func:`launches`
reads. A kernel can count on the device too, into a :func:`device_counter`:
``qam_eq_scan.rounds`` (the rounds that instance ran, summed over channels).
:func:`snapshot` reads those, and only it does, so a step adds no sync.
"""

from __future__ import annotations

import functools
import threading
import time

__all__ = ["PREFIX", "count", "device_counter", "enable", "kernel", "launches", "reset",
           "snapshot", "span", "spanned"]

PREFIX = "yagi."

_on = False
_clock = time.perf_counter_ns
_spans: dict[str, list[int]] = {}  # name -> [count, ns, self ns]
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
    __slots__ = ("name", "t0", "child_ns", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.child_ns = 0
        self.stack = _stack()
        self.stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self.t0
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
    """Clear the span totals and the counters, the device's too (not the
    kernels' launches)."""
    _spans.clear()
    _counters.clear()
    for per in _device_counters.values():
        for t in per.values():
            t.zero_()


def span(name: str, always: bool = False):
    """A context manager that adds the time inside it to span ``name``
    while tracing is on, or with ``always`` (set-up work) in any case."""
    return _Span(name) if _on or always else _OFF


def spanned(name: str, always: bool = False):
    """Decorator: each call of the function runs inside ``span(name, always)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_on or always):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

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
    here: a sync of each device that has one) and ``launches`` (name ->
    count)."""
    counters = dict(_counters)
    for name, per in _device_counters.items():
        counters[name] = counters.get(name, 0) + sum(int(t.item()) for t in per.values())
    return {
        "spans": {n: {"count": c, "ns": ns, "self_ns": s} for n, (c, ns, s) in _spans.items()},
        "counters": counters,
        "launches": launches(),
    }
