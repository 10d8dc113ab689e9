"""Eager step time of config[0], config[4], config[1], config[3] and
config[2] on one card (and of parallel/'s streamed config[4]), and where the
device time goes.

For each path, 3 warm-up steps and then ``--steps`` eager steps with the
state carried, over four random blocks from a seed: the device time per step
between CUDA events, the host's time to enqueue a step, then a
``torch.profiler`` table of device time by kernel over 5 more steps, then
5 more steps profiled with the program's tracing on, its span intervals put
on the profiler's clock and each idle stretch of the device named by the
innermost program span that covers at least half of it (``outside`` where
none does: the tool's loop), then the program's own span totals a step
(:mod:`yagi_tpu_torch.trace`: count, host ms and self ms of each span) over
``--steps`` more steps with its tracing on and no profiler.

* ``0``, config[0]: ``FusedRxChain.step``, 16 channels × 2^17 complex samples;
* ``4``, config[4]: ``ChannelizerFmRx.step`` (K2's FM instance at M = 64,
  2^15 steps, p = 8: the channels, the FM discriminator and the state in one
  launch), 2^21 complex samples a block, seed 1;
* ``1``, config[1]: ``ResampSymsyncRx.step`` (``MsResamp`` at rate
  2/2.0663 → ``Symsync.execute_slots`` at k_out = 1, K3), 1024 channels ×
  4096 samples; ``1p``, the two objects chained by hand with
  ``backend="pallas"``: ``branch_outputs`` builds the all-branch stream and
  K4 runs the loop on it;
* ``3``, config[3]: ``QamRx.step_masked``, 2048 channels × 4096 samples;
* ``2``, config[2]: ``FmStereoRx.step``, 512 channels × 2^14 samples
  (default_rng(3) standard-normal × 0.1): the discriminator, four 129-tap
  FIRs as banded matmuls, the two de-emphasis IIRs on ``iir_chunked``.

* ``4s``, ``parallel/`` at world size 1 (one NCCL rank):
  ``sharded_channelize_stream_fm_to_channels`` over 4 config[4] blocks a
  step (the plain Firpfbch analyzer, the all_to_all, the FM discriminator);
  ``4f``, the unsharded Firpfbch → Freqdem over the same 4 blocks a step,
  state carried.

* ``l4``: each of layer L4's streaming filters of ``chip_smoke.py``'s
  ``[filters]`` phase (:func:`.paths.make_filters`) at config[1]'s width,
  1024 channels × 4096 samples a block, state carried, one measurement
  each.

* ``mod``: the heaviest objects of ``chip_smoke.py``'s ``[modems]``
  phase at its widths (:mod:`.paths`): the 16-QAM receiver (an ``"nco"``
  ``Osc`` down-mix, ``demodulate``, ``demodulate_soft``,
  ``demodulate_with_stats``) at 1024 × 4096 symbols, GMSK and FSK
  modulate → demodulate at 1024 × 2048 symbols, ``AmpModem`` (USB with a
  carrier) modulate → demodulate at 1024 × 2048, and ``Eqrls.train_block``
  (p 7) at 256 × 256, each one measurement.

* ``frame``: ``FrameSync64.execute`` on one impaired frame64 burst (a
  4096-sample buffer of :func:`.paths.frame_bursts`, four cycled): the
  detection's FFT surface, the timing and carrier recovery in complex128,
  the header's and payload's decode (the payload's conv27p23 Viterbi over
  822 trellis steps, a torch loop).

Each measurement also prints the device operations a step (kernels,
copies, fills in the profiler's trace) and the device's idle share: one
minus the union of the device operations' intervals (operations that
overlap count once) over the profiled window's wall time.

* ``cost``: the host cost of the program's tracing, ns a call: a span site
  with tracing off, an entry's later step's check of its first step, a span
  with tracing on (its interval kept, the buffer full).

``--configs`` picks some of them (default all but ``l4``, ``mod``, ``frame``
and ``cost``), for example ``4,1p``.

The shapes and constructors are those of :mod:`.paths`, which
``chip_smoke.py`` uses too.

It imports the port by absolute name, so it also times another checkout of
the package whose ``tools/paths.py`` has the same names, as run from that
checkout's root::

    python -m yagi_tpu_torch.tools.step_profile
    (cd <other checkout> && PYTHONPATH=$PWD python <this file>)
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from yagi_tpu_torch import trace
from yagi_tpu_torch.tools import paths
from yagi_tpu_torch.tools.paths import (
    C1,
    C3,
    QAM_SEED,
    T1,
    T3,
    complex_block,
    make_msresamp,
    make_qamrx,
    make_symsync,
)


def blocks(c: int, n: int, device) -> list[torch.Tensor]:
    rng = np.random.default_rng(QAM_SEED)
    return [complex_block(rng, (c, n), device) for _ in range(4)]


def config0(device):
    xs = blocks(paths.C0, paths.T0, device)
    state = [paths.make_fused(paths.C0, device), 0]

    def step():
        state[0] = state[0].step(xs[state[1] % 4])[2]
        state[1] += 1

    return step


def config4(device):
    rng = np.random.default_rng(paths.CHZ_SEED)
    n = paths.M4 * paths.T4
    xs = [tuple(torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(device)
                for _ in range(2)) for _ in range(4)]
    state = [paths.make_chzfm(device), 0]

    def step():
        state[0] = state[0].step(*xs[state[1] % 4])[3]
        state[1] += 1

    return step


def config4_stream(device, sharded: bool):
    """4 config[4] blocks (bench.py's draw, seed 1) a step: through
    parallel/'s stream at world size 1, or through Firpfbch → Freqdem."""
    import socket

    from yagi_tpu_torch.modem import Freqdem
    from yagi_tpu_torch.multichannel import Firpfbch
    from yagi_tpu_torch.parallel import make_stream_mesh, sharded_channelize_stream_fm_to_channels
    from yagi_tpu_torch.parallel.multihost import initialize_multihost

    rng = np.random.default_rng(paths.CHZ_SEED)
    n = paths.M4 * paths.T4
    xs = torch.stack([torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                                       .astype(np.complex64)).to(device) for _ in range(4)])
    if sharded:
        with socket.socket() as sk:  # a free port on this host: no network
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        initialize_multihost(f"tcp://127.0.0.1:{port}", 1, 0)  # a no-op once joined
        mesh = make_stream_mesh()
        chz = Firpfbch.create_kaiser(paths.M4, 4, 60.0, device=device)
        return lambda: sharded_channelize_stream_fm_to_channels(chz, paths.KF, xs, mesh)
    state = [Firpfbch.create_kaiser(paths.M4, 4, 60.0, device=device),
             Freqdem.create(paths.KF, batch_shape=(paths.M4,), device=device)]

    def step():
        for x in xs:
            y, state[0] = state[0].analyzer_execute(x)
            _, state[1] = state[1].demodulate(y)

    return step


def config1(device):
    xs = blocks(C1, T1, device)
    state = [paths.make_symrx(C1, device), 0]

    def step():
        state[0] = state[0].step(xs[state[1] % 4])[2]
        state[1] += 1

    return step


def config1_pallas(device):
    xs = blocks(C1, T1, device)
    state = [make_msresamp(C1, device), make_symsync(C1, device), 0]

    def step():
        y, cnt, state[0] = state[0].execute_block(xs[state[2] % 4])
        _, _, state[1] = state[1].execute_slots(y, n_valid=cnt, backend="pallas")
        state[2] += 1

    return step


def config3(device):
    xs = blocks(C3, T3, device)
    state = [make_qamrx(C3, device), 0]

    def step():
        state[0] = state[0].step_masked(xs[state[1] % 4])[3]
        state[1] += 1

    return step


def config2(device):
    rng = np.random.default_rng(paths.FM_SEED)
    xs = [paths.fm_block(rng, (paths.C2, paths.T2), device) for _ in range(4)]
    state = [paths.make_fmstereo(paths.C2, device), 0]

    def step():
        state[0] = state[0].step(xs[state[1] % 4])[3]
        state[1] += 1

    return step


def filter_steps(device) -> list:
    """(name, step) of each L4 filter, over four config[1]-width blocks."""
    xs = blocks(C1, T1, device)
    out = []
    for name, st, call in paths.make_filters(C1, T1, device):
        state = [st, 0]

        def step(state=state, call=call):
            state[0] = call(state[0], xs[state[1] % 4])[2]
            state[1] += 1

        out.append((f"L4 {name}", step))
    return out


def modem_steps(device) -> list:
    """(name, step, steps) of the ``[modems]`` phase's heaviest objects, state carried over
    four blocks each."""
    from yagi_tpu_torch.equalization import Eqrls
    from yagi_tpu_torch.modem import AmpModem, Fskdem, Fskmod, GmskDem, GmskMod, Modem
    from yagi_tpu_torch.nco import Osc

    rng = np.random.default_rng(13)
    c, b = paths.MOD_C, (paths.MOD_C,)

    def ints(hi: int, n: int) -> list[torch.Tensor]:
        return [torch.from_numpy(rng.integers(0, hi, (c, n))).to(device) for _ in range(4)]

    def chain(objs: list, call, xs: list):
        state = [objs, 0]

        def step():
            state[0] = call(state[0], xs[state[1] % 4])
            state[1] += 1

        return step

    qam = Modem.create("qam16", batch_shape=b, device=device)
    ys = [qam.modulate(s)[0] + 0.03 * complex_block(rng, s.shape, device)
          for s in ints(16, paths.QAM_SYMS)]

    def rx(st, y):
        osc, m = st
        y, osc = osc.mix_block_down(y)
        m = m.demodulate(y)[1]
        m = m.demodulate_soft(y)[2]
        return osc, m.demodulate_with_stats(y)[4]

    def mod_dem(st, x):
        tx, rx_ = st
        y, tx = tx.modulate(x)
        return tx, rx_.demodulate(y)[1]

    audio = [0.5 * torch.rand(c, paths.AM_N, device=device) for _ in range(4)]
    n_eq = paths.EQRLS_N // 4
    eq_x = [complex_block(rng, (paths.EQRLS_C, n_eq), device) for _ in range(4)]
    eq = Eqrls.create(p=paths.EQRLS_P, batch_shape=(paths.EQRLS_C,), device=device)
    return [
        ("[modems] 16-QAM receiver", chain(
            (Osc.create("nco", batch_shape=b, device=device),
             Modem.create("qam16", batch_shape=b, device=device)), rx, ys), 20),
        ("[modems] GMSK modulate -> demodulate", chain(
            (GmskMod.create(2, 3, 0.3, b, device=device),
             GmskDem.create(2, 3, 0.3, b, device=device)), mod_dem,
            ints(2, paths.GMSK_BITS)), 20),
        ("[modems] FSK modulate -> demodulate", chain(
            (Fskmod.create(2, 8, 0.2, b, device=device),
             Fskdem.create(2, 8, 0.2, b, device=device)), mod_dem,
            ints(4, paths.FSK_SYMS)), 20),
        ("[modems] AmpModem usb modulate -> demodulate", chain(
            AmpModem.create(0.5, "usb", batch_shape=b, device=device),
            lambda m, x: m.demodulate(m.modulate(x)[0])[1], audio), 20),
        ("[modems] Eqrls.train_block", chain(
            eq, lambda e, x: e.train_block(x, x)[1], eq_x), 2),
    ]


def frame_step(device):
    """FrameSync64.execute on four impaired frame64 bursts in turn."""
    from yagi_tpu_torch.framing import FrameSync64

    bufs = paths.frame_bursts(4, paths.FRAME_SEED, device)[0]
    state = [FrameSync64(device=device), 0]

    def step():
        state[0].execute(bufs[state[1] % 4])
        state[1] += 1

    return step


def busy_us(events) -> float:
    """The length in µs of the union of the events' intervals: operations
    that overlap in time count once."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


STEP_MARK = "step_profile.step"  # the profiler's own range around each step of the traced pass
# steps run under the profiler before the traced pass's window: the first
# launches after it starts wait on its set-up (3.4 ms in config[1]'s first)
PRIME_STEPS = 2


def profiler_origin_ns(prof, anchor: dict) -> tuple[int, str]:
    """The profiler's trace start (its events' zero) on the program's span
    clock, and the clock the profiler read it on: ``wall`` (put on the span
    clock through the timeline's ``anchor``) or ``monotonic`` (the span
    clock itself), whichever the start lies nearer to now."""
    start = prof.profiler.kineto_results.trace_start_ns()
    if abs(time.time_ns() - start) < abs(time.perf_counter_ns() - start):
        return start - (anchor["wall_ns"] - anchor["clock_ns"]), "wall"
    return start, "monotonic"


def idle_gaps(ops: list, spans: list, lo: float, hi: float) -> list[tuple[str, float]]:
    """Each stretch of ``[lo, hi]`` that no device op ``(start, end)``
    covers, named by the innermost (shortest) program span ``(name, start,
    end)`` that covers at least half of it, else ``outside``; all in µs on
    one clock, longest first."""
    gaps, at = [], lo
    for a, b in sorted(ops):
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    out = []
    for a, b in gaps:
        if b <= a:
            continue
        covering = [(e - s, n) for n, s, e in spans if min(b, e) - max(a, s) >= 0.5 * (b - a)]
        out.append((min(covering)[1] if covering else "outside", b - a))
    return sorted(out, key=lambda g: -g[1])


def program_gaps(name: str, step, steps: int = 5) -> None:
    """Profile ``steps`` steps with the program's tracing on, after
    :data:`PRIME_STEPS` under the profiler and drained, put its span
    intervals on the profiler's clock, check them against the profiler's own
    range of each step, and print the device's idle stretches by the program
    span they fall in."""
    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PRIME_STEPS):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(steps):
                with record_function(STEP_MARK):
                    step()
            torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
    finally:
        trace.enable(False)
    tl = trace.snapshot()["timeline"]
    origin, clock = profiler_origin_ns(prof, tl["anchor"])

    def us(ns: int) -> float:
        return (ns - origin) / 1e3

    spans = [(n, us(a), us(b)) for n, a, b in tl["steps"]]
    marks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == STEP_MARK and e.device_type == DeviceType.CPU)
    leads = []  # µs from each step's profiler range to the first program span in it
    for a, b in marks:
        inside = [s for _, s, e in spans if a <= s and e <= b]
        if inside:
            leads.append(min(inside) - a)
    lead = f"median lead {statistics.median(leads):.1f} µs" if leads else "no span inside"
    print(f"[gaps] {name}: trace start on the {clock} clock; {len(leads)} of {len(marks)} "
          f"profiled steps hold the program's spans, {lead}")
    ops = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    lo, hi = us(t0), us(t1)
    gaps = idle_gaps(ops, spans, lo, hi)
    idle = sum(g for _, g in gaps)
    print(f"[gaps] {name}: idle {100 * idle / (hi - lo):.1f}% of {(hi - lo) / steps / 1e3:.4f} ms "
          f"a step with tracing on, {len(gaps)} stretches")
    by = {}
    for label, g in gaps:
        n, total = by.get(label, (0, 0.0))
        by[label] = (n + 1, total + g)
    for label, (n, total) in sorted(by.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[gaps]   {label}: {n} stretches, {total / steps:.1f} µs a step "
              f"({100 * total / idle:.1f}% of idle)")


def span_cost(n: int = 200_000, repeats: int = 5) -> None:
    """Print the host ns a call of the program's tracing costs (the median of
    ``repeats`` timings of ``n`` calls each, less a plain call's)."""
    def plain():
        return None

    off = trace.spanned("yagi.cost.off")(plain)
    later = trace.spanned("yagi.cost.step", first="yagi.cost.first_step")(plain)
    on = trace.spanned("yagi.cost.on")(plain)
    later()  # takes its first step

    def ns(fn) -> float:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            times.append((time.perf_counter_ns() - t0) / n)
        return statistics.median(times)

    def with_span():
        with trace.span("yagi.cost.with"):
            pass

    trace.reset()
    base = ns(plain)
    row = {"a span site, tracing off": ns(off) - base,
           "a later step's first-step check, tracing off": ns(later) - ns(off),
           "a with-span, tracing off": ns(with_span) - base}
    trace.enable()
    try:
        row["a span, tracing on, its interval kept"] = ns(on) - base
        row["a with-span, tracing on, its interval kept"] = ns(with_span) - base
    finally:
        trace.enable(False)
    dropped = trace.snapshot()["timeline"]["dropped"]
    trace.reset()
    for what, v in row.items():
        print(f"[cost] {what}: {v:.1f} ns")
    print(f"[cost] the step buffer ({trace.STEP_INTERVALS} intervals) dropped {dropped}")


def program_spans(step, steps: int) -> None:
    """Print the program's span totals a step over ``steps`` steps with its
    tracing on."""
    trace.reset()
    trace.enable()
    try:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    finally:
        trace.enable(False)
    totals = trace.snapshot()["spans"]
    for name, t in sorted(totals.items(), key=lambda kv: -kv[1]["ns"]):
        print(f"[span] {name}: {t['count'] / steps:.2f} a step, {t['ns'] / steps / 1e6:.4f} ms "
              f"a step, self {t['self_ns'] / steps / 1e6:.4f} ms")


def measure(name: str, step, steps: int) -> None:
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    host = (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize()
    print(f"[step] {name}: {start.elapsed_time(end) / steps:.4f} ms per step between CUDA "
          f"events, {host:.4f} ms per step to enqueue ({steps} eager steps)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=14,
                                    max_name_column_width=50))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us(dev)
    print(f"[step] {name}: {len(dev) / 5:.0f} device ops per step, device busy "
          f"{busy / 5e3:.4f} ms of {wall_us / 5e3:.4f} ms a step (idle "
          f"{100 * (1 - busy / wall_us):.1f}%)")
    program_gaps(name, step)
    program_spans(step, steps)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--configs", default="0,4,1,1p,3,2")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA device; torch sees none")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[step] card: {card}")
    runs = {
        "0": ("config[0] FusedRxChain.step", lambda: config0(device), 10 * args.steps),
        "4": ("config[4] ChannelizerFmRx.step", lambda: config4(device), 10 * args.steps),
        "1": ("config[1] ResampSymsyncRx.step", lambda: config1(device), args.steps),
        "1p": ("config[1] MsResamp -> Symsync(backend='pallas')",
               lambda: config1_pallas(device), max(2, args.steps // 4)),
        "3": ("config[3] QamRx.step_masked", lambda: config3(device), args.steps),
        "2": ("config[2] FmStereoRx.step", lambda: config2(device), args.steps),
        "4s": ("parallel/ stream FM, 4 config[4] blocks, world size 1",
               lambda: config4_stream(device, True), args.steps),
        "4f": ("Firpfbch -> Freqdem, the same 4 blocks", lambda: config4_stream(device, False),
               args.steps),
        "frame": ("FrameSync64.execute, one impaired frame64 burst", lambda: frame_step(device),
                  args.steps),
    }
    for key in args.configs.split(","):
        if key == "l4":
            for name, step in filter_steps(device):
                measure(name, step, args.steps)
            continue
        if key == "cost":
            span_cost()
            continue
        if key == "mod":
            for name, step, steps in modem_steps(device):
                measure(name, step, steps)
            continue
        name, make, steps = runs[key]
        measure(name, make(), steps)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
