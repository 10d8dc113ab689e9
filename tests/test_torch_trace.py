"""The port's own tracing (``yagi_tpu_torch.trace``): off it hands every site
one shared no-op and keeps nothing; on it keeps counts, times and self times
by name, each span's time taken from its parent's self time on its own
thread; set-up spans and counters record either way; the entries' outputs and
state are the same with it on or off; nothing reaches a profiler's trace; the
registry lists every kernel wrapper. The timeline: set-up intervals kept on
or off and placed on the wall clock by the anchor, step intervals in a
bounded buffer, each entry's first step spanned once a process and its later
steps reading no clock, no device span on the CPU."""

import collections
import dataclasses
import importlib
import os
import threading
import time

import pytest
import torch

from yagi_tpu_torch import trace
from yagi_tpu_torch._src import device as device_mod
from yagi_tpu_torch.chains import ChannelizerFmRx, FmStereoRx, FusedRxChain, QamRx, ResampSymsyncRx

torch.set_num_threads(1)

DEV = "cpu"
# each kernel wrapper, by the module of yagi_tpu_torch.kernels that holds it
WRAPPERS = {"agc_scan_apply": "agc", "fused_chain_apply": "chain", "fused_chain_apply_c64": "chain",
            "fused_channelizer_apply": "channelizer", "fir_block_apply": "fir",
            "iir_chunked_apply": "iir",
            "iir_scan_apply": "iir", "mix_down_apply": "mix", "qam_eq_scan_apply": "qam",
            "resamp_u32_apply": "resamp", "symsync_fused_apply": "symscan",
            "symsync_scan_apply": "symscan"}
QAM_STAGES = ("yagi.agc.run", "yagi.symsync.run", "yagi.qamrx.eq", "yagi.qamrx.state")


@pytest.fixture(autouse=True)
def clean_trace():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _block(c, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn((c, n), generator=g), torch.randn((c, n), generator=g))


def _fields(obj):
    """Every tensor of a state object, nested states flattened, by path."""
    out = {}
    for name, v in vars(obj).items():
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{name}.{k}": t for k, t in _fields(v).items()})
    return out


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        fa, fb = _fields(a), _fields(b)
        return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    return a == b


def test_off_hands_out_one_shared_span_and_keeps_nothing():
    assert trace.span("yagi.a") is trace.span("yagi.b")
    with trace.span("yagi.a"):
        with trace.span("yagi.b"):
            pass
    trace.spanned("yagi.c")(lambda: None)()
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


def test_nesting_parents_and_self_time_under_a_fake_clock(monkeypatch):
    ticks = iter(range(0, 1000, 10))  # each clock read 10 ns after the last
    monkeypatch.setattr(trace, "_clock", lambda: next(ticks))
    trace.enable()
    with trace.span("yagi.outer"):  # reads 0 ... 70
        with trace.span("yagi.inner"):  # 10 ... 20
            pass
        with trace.span("yagi.inner"):  # 30 ... 60
            with trace.span("yagi.leaf"):  # 40 ... 50
                pass
    spans = trace.snapshot()["spans"]
    assert spans["yagi.outer"] == {"count": 1, "ns": 70, "self_ns": 70 - 10 - 30}
    assert spans["yagi.inner"] == {"count": 2, "ns": 40, "self_ns": 40 - 10}
    assert spans["yagi.leaf"] == {"count": 1, "ns": 10, "self_ns": 10}


def test_a_span_closed_by_an_exception_is_kept_and_the_exception_passes():
    trace.enable()
    with pytest.raises(KeyError):
        with trace.span("yagi.outer"):
            with trace.span("yagi.inner"):
                raise KeyError("x")
    spans = trace.snapshot()["spans"]
    assert spans["yagi.outer"]["count"] == spans["yagi.inner"]["count"] == 1
    assert trace._stack() == []  # the stack is empty again


def test_set_up_spans_and_counters_record_with_tracing_off():
    FusedRxChain.create(batch_shape=(2,), device=DEV)
    trace.count("library.builds")
    snap = trace.snapshot()
    create, taps = snap["spans"]["yagi.rxchain.create"], snap["spans"]["yagi.rxchain.taps"]
    assert create["count"] == taps["count"] == 1
    assert create["self_ns"] == create["ns"] - taps["ns"]  # the taps lie inside create
    assert snap["counters"] == {"library.builds": 1}
    trace.reset()
    assert trace.snapshot()["counters"] == {}


def test_device_counters_are_read_by_snapshot_and_zeroed_by_reset(monkeypatch):
    """A kernel's device counter (a CPU tensor here): one int64 a name and
    device, read by snapshot beside the host's counters, zeroed by reset; the
    CPU route of qam_eq_scan_apply counts neither slots nor rounds."""
    from yagi_tpu_torch.kernels.qam import qam_eq_scan_apply

    monkeypatch.setattr(trace, "_device_counters", {})
    cpu = torch.device("cpu")
    t = trace.device_counter("qam_eq_scan.rounds", cpu)
    assert trace.device_counter("qam_eq_scan.rounds", cpu) is t
    assert t.dtype == torch.int64 and t.shape == (1,) and int(t) == 0
    t += 1950
    trace.count("qam_eq_scan.slots", 8192)
    assert trace.snapshot()["counters"] == {"qam_eq_scan.slots": 8192, "qam_eq_scan.rounds": 1950}
    trace.reset()
    assert trace.snapshot()["counters"] == {"qam_eq_scan.rounds": 0}
    rx = QamRx.create(batch_shape=(2,), device=DEV)
    y = _block(2, 32, 3)
    qam_eq_scan_apply(y, torch.ones(2, 32, dtype=torch.bool), *rx.eq_scan_args())
    assert trace.snapshot()["counters"] == {"qam_eq_scan.rounds": 0}


def test_registry_lists_the_ten_wrappers():
    counts = trace.launches()
    assert sorted(counts) == sorted(WRAPPERS)
    for name, module in WRAPPERS.items():
        fn = getattr(importlib.import_module(f"yagi_tpu_torch.kernels.{module}"), name)
        assert counts[name] == fn.launches and fn.__name__ == name
        assert fn.launch_span == f"yagi.kernel.{name}.launch"
    mix = importlib.import_module("yagi_tpu_torch.kernels.mix").mix_down_apply
    mix.launches += 3
    try:
        assert trace.launches()["mix_down_apply"] == counts["mix_down_apply"] + 3
    finally:
        mix.launches -= 3


def test_qamrx_step_records_each_stage_once_and_no_launch_on_cpu():
    rx = QamRx.create(batch_shape=(4,), device=DEV)
    x = _block(4, 64, 1)
    trace.enable()
    rx.step_masked(x)
    snap = trace.snapshot()
    spans = snap["spans"]
    step = spans["yagi.qamrx.step"]
    assert step["count"] == 1 and all(spans[stage]["count"] == 1 for stage in QAM_STAGES)
    # self time is exact in ns: the stages are the step's children, each wrapper its stage's
    assert step["self_ns"] == step["ns"] - sum(spans[stage]["ns"] for stage in QAM_STAGES)
    for wrapper, stage in (("agc_scan_apply", "yagi.agc.run"),
                           ("symsync_fused_apply", "yagi.symsync.run"),
                           ("qam_eq_scan_apply", "yagi.qamrx.eq")):
        kernel = spans[f"yagi.kernel.{wrapper}"]
        assert kernel["count"] == 1 and kernel["self_ns"] == kernel["ns"]
        assert spans[stage]["self_ns"] == spans[stage]["ns"] - kernel["ns"]
    assert spans["yagi.qamrx.state"]["self_ns"] == spans["yagi.qamrx.state"]["ns"]
    assert not [n for n in spans if n.endswith(".launch")]  # the CPU route launches nothing
    assert all(n.startswith(trace.PREFIX) for n in spans)


def test_rxchain_step_records_its_advance():
    chain = FusedRxChain.create(batch_shape=(2,), device=DEV)
    trace.reset()
    trace.enable()
    chain.step(_block(2, 256, 2))
    chain.step_planar(torch.zeros((2, 256)), torch.zeros((2, 256)))
    spans = trace.snapshot()["spans"]
    step = spans["yagi.rxchain.step"]
    children = ("yagi.rxchain.advance", "yagi.kernel.fused_chain_apply_c64",
                "yagi.kernel.fused_chain_apply")
    assert step["count"] == spans["yagi.rxchain.advance"]["count"] == 2
    assert spans[children[1]]["count"] == spans[children[2]]["count"] == 1
    assert step["self_ns"] == step["ns"] - sum(spans[c]["ns"] for c in children)
    assert "yagi.rxchain.create" not in spans  # set-up came before the reset


@pytest.mark.parametrize("entry", ["rxchain", "qamrx"])
def test_outputs_and_state_are_the_same_with_tracing_on_and_off(entry):
    if entry == "rxchain":
        obj = FusedRxChain.create(batch_shape=(3,), device=DEV)
        blocks = [_block(3, 256, s) for s in range(3)]

        def run(o, x):
            y, n, o = o.step(x)
            return (y, n), o
    else:
        obj = QamRx.create(batch_shape=(3,), device=DEV)
        blocks = [_block(3, 32, s) for s in range(3)]

        def run(o, x):
            *out, o = o.step_masked(x)
            return out, o

    results = []
    for on in (False, True, False):
        trace.enable(on)
        o, outs = obj, []
        for x in blocks:
            out, o = run(o, x)
            outs.append(out)
        results.append((outs, o))
    for outs, state in results[1:]:
        assert _same(outs, results[0][0]) and _same(state, results[0][1])


def test_spans_add_nothing_to_a_profilers_trace():
    from torch.autograd import DeviceType

    rx = QamRx.create(batch_shape=(2,), device=DEV)
    x = _block(2, 32, 3)
    names = []
    for on in (False, True):
        trace.enable(on)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            rx.step_masked(x)
        names.append(sorted(e.name for e in prof.events() if e.device_type == DeviceType.CPU))
    assert names[0] == names[1]
    assert not [n for n in names[1] if n.startswith(trace.PREFIX)]
    assert trace.snapshot()["spans"]["yagi.qamrx.step"]["count"] == 1  # kept on the host


def test_each_thread_nests_its_own_spans():
    trace.enable()
    opened, done = threading.Event(), threading.Event()

    def outer():
        with trace.span("yagi.outer"):
            opened.set()
            done.wait(10)

    t = threading.Thread(target=outer)
    t.start()
    assert opened.wait(10)
    with trace.span("yagi.other"):  # open while yagi.outer is, on another thread
        with trace.span("yagi.inner"):
            pass
    done.set()
    t.join(10)
    spans = trace.snapshot()["spans"]
    assert spans["yagi.outer"]["self_ns"] == spans["yagi.outer"]["ns"] > 0
    assert spans["yagi.other"]["self_ns"] == spans["yagi.other"]["ns"] - spans["yagi.inner"]["ns"]


def test_step_profile_counts_overlapping_device_time_once():
    from types import SimpleNamespace

    from yagi_tpu_torch.tools.step_profile import busy_us

    def op(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end))

    # [0, 10] and [5, 12] overlap, [12, 15] touches, [20, 21] stands alone, [1, 2] lies inside
    ops = [op(5, 12), op(0, 10), op(20, 21), op(12, 15), op(1, 2)]
    assert busy_us(ops) == 16
    assert busy_us([]) == 0


def test_step_profile_names_each_idle_gap_by_the_innermost_span_over_half_of_it():
    from yagi_tpu_torch.tools.step_profile import idle_gaps

    ops = [(5, 12), (0, 10), (20, 21), (12, 15)]  # busy [0, 15] and [20, 21] of [0, 25]
    spans = [("yagi.a.step", 0, 30), ("yagi.kernel.x", 14, 19), ("yagi.b", 15, 40),
             ("yagi.short", 22, 23)]  # yagi.short covers a quarter of [21, 25]: too little
    assert idle_gaps(ops, spans, 0, 25) == [("yagi.kernel.x", 5), ("yagi.b", 4)]
    assert idle_gaps(ops, [], 0, 25) == [("outside", 5), ("outside", 4)]
    assert idle_gaps([], spans, 2, 3) == [("yagi.a.step", 1)]


def test_step_profile_puts_the_program_spans_on_the_profilers_clock():
    """Each step's span, put on the profiler's clock by its trace start and
    the timeline's anchor, lies inside the profiler's own range of that step
    (within 0.2 ms, the clocks' reads; a wrong clock is off by years)."""
    from yagi_tpu_torch.tools.step_profile import profiler_origin_ns

    rx = QamRx.create(batch_shape=(2,), device=DEV)
    x = _block(2, 32, 3)
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("mark"):
                rx.step_masked(x)
    tl = trace.snapshot()["timeline"]
    origin, _ = profiler_origin_ns(prof, tl["anchor"])
    marks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == "mark")
    steps = [((a - origin) / 1e3, (b - origin) / 1e3) for n, a, b in tl["steps"]
             if n == "yagi.qamrx.step"]
    assert len(marks) == len(steps) == 3
    for (ma, mb), (a, b) in zip(marks, steps):
        assert ma - 200 <= a < b <= mb + 200


def _planes(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, n), generator=g)


# each entry: its create at a tiny size on the CPU, and one step returning the new state
ENTRIES = {
    "rxchain": (lambda **kw: FusedRxChain.create(batch_shape=(2,), **kw),
                lambda o: o.step(_block(2, 256, 1))[-1]),
    "qamrx": (lambda **kw: QamRx.create(batch_shape=(2,), **kw),
              lambda o: o.step_masked(_block(2, 32, 1))[-1]),
    "chzfm": (lambda **kw: ChannelizerFmRx.create(**kw), lambda o: o.step(*_planes(16384, 1))[-1]),
    "symrx": (lambda **kw: ResampSymsyncRx.create(2, **kw), lambda o: o.step(_block(2, 256, 1))[-1]),
    "fmrx": (lambda **kw: FmStereoRx.create(batch_shape=(2,), **kw),
             lambda o: o.step(_block(2, 256, 1))[-1]),
}


@pytest.fixture
def fresh_firsts(monkeypatch):
    """A process in which no entry has stepped yet."""
    monkeypatch.setattr(trace, "_firsts", set())


def _process_start_ns() -> int:
    """This process's start on the wall clock, from ``/proc`` (10-ms ticks)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.time_ns() - time.clock_gettime_ns(time.CLOCK_BOOTTIME) + \
        ticks * 10**9 // os.sysconf("SC_CLK_TCK")


def test_the_timeline_keeps_set_up_intervals_in_order_with_tracing_off():
    FusedRxChain.create(batch_shape=(2,), device=DEV)
    QamRx.create(batch_shape=(2,), device=DEV)
    tl = trace.snapshot()["timeline"]
    assert [n for n, _, _ in tl["setup"]] == ["yagi.rxchain.create", "yagi.rxchain.taps",
                                              "yagi.qamrx.create"]
    (_, c0, c1), (_, t0, t1), (_, q0, q1) = tl["setup"]
    assert c0 <= t0 <= t1 <= c1 <= q0 <= q1  # the taps inside create, then the next create
    assert tl["steps"] == [] and tl["dropped"] == 0  # no step span while tracing is off
    anchor = tl["anchor"]
    lo, hi = _process_start_ns() - 20_000_000, time.time_ns()  # the /proc start has 10-ms ticks
    for _, a, b in tl["setup"]:
        assert lo <= anchor["wall_ns"] + (a - anchor["clock_ns"]) <= \
            anchor["wall_ns"] + (b - anchor["clock_ns"]) <= hi


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_first_step_is_taken_once_per_entry_per_process(entry, fresh_firsts):
    create, step = ENTRIES[entry]
    obj = step(step(create(device=DEV)))
    snap = trace.snapshot()
    first = f"yagi.{entry}.first_step"
    assert snap["spans"][first]["count"] == 1
    setup = snap["timeline"]["setup"]
    assert [n for n, _, _ in setup].count(first) == 1
    made = next(iv for iv in setup if iv[0] == f"yagi.{entry}.create")
    taken = next(iv for iv in setup if iv[0] == first)
    assert made[2] <= taken[1]  # the first step came after create
    assert f"yagi.{entry}.step" not in snap["spans"]  # tracing off: the set-up span alone
    trace.enable()
    step(obj)  # a later step with tracing on: its span, no second first step
    spans = trace.snapshot()["spans"]
    assert spans[first]["count"] == 1 and spans[f"yagi.{entry}.step"]["count"] == 1


def test_rxchains_two_steps_share_one_first_step(fresh_firsts):
    chain = FusedRxChain.create(batch_shape=(2,), device=DEV)
    chain.step_planar(torch.zeros((2, 256)), torch.zeros((2, 256)))
    chain.step(_block(2, 256, 2))
    assert trace.snapshot()["spans"]["yagi.rxchain.first_step"]["count"] == 1


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_later_step_with_tracing_off_reads_no_clock_and_keeps_nothing(entry, fresh_firsts,
                                                                       monkeypatch):
    create, step = ENTRIES[entry]
    obj = step(create(device=DEV))
    before = trace.snapshot()

    def refused(*args):
        raise AssertionError("a later step with tracing off read the clock or made a span")

    monkeypatch.setattr(trace, "_clock", refused)
    monkeypatch.setattr(trace, "_Span", refused)
    step(obj)
    after = trace.snapshot()
    assert after["timeline"] == before["timeline"] and after["spans"] == before["spans"]


def test_the_step_buffer_keeps_its_bound_and_counts_its_drops(monkeypatch):
    assert trace._steps.maxlen == trace.STEP_INTERVALS == 65_536
    monkeypatch.setattr(trace, "_steps", collections.deque(maxlen=4))
    trace.enable()
    for i in range(10):
        with trace.span(f"yagi.s{i}"):
            pass
    with trace.span("yagi.made", always=True):
        pass
    snap = trace.snapshot()
    tl = snap["timeline"]
    assert [n for n, _, _ in tl["steps"]] == ["yagi.s6", "yagi.s7", "yagi.s8", "yagi.s9"]
    assert tl["dropped"] == 6
    assert [n for n, _, _ in tl["setup"]] == ["yagi.made"]  # set-up spans are not in the buffer
    assert snap["spans"]["yagi.s0"]["count"] == 1  # the totals keep what the buffer dropped
    trace.reset()
    tl = trace.snapshot()["timeline"]
    assert tl["steps"] == [] and tl["setup"] == [] and tl["dropped"] == 0


def test_resolve_device_opens_no_span_on_the_cpu():
    for dev in ("cpu", torch.device("cpu")):
        assert device_mod.resolve_device(dev) == torch.device("cpu")
    snap = trace.snapshot()
    assert "yagi.device" not in snap["spans"] and snap["timeline"]["setup"] == []


def test_a_factorys_device_resolves_before_its_span(monkeypatch):
    """``resolves_device``: the device (here a fake card's first use) is
    resolved, and its span closed, before the factory's set-up span opens,
    whether the device is given by name or by position."""
    opened = []

    def fake_open(index):
        with trace.span("yagi.device", always=True):
            opened.append(index)

    monkeypatch.setattr(device_mod, "_open", fake_open)

    @device_mod.resolves_device
    @trace.spanned("yagi.fake.create", always=True)
    def create(n, device=None):
        return n, device

    assert create(3, device="cuda:1") == (3, torch.device("cuda", 1))
    assert create(4, "cuda:1") == (4, torch.device("cuda", 1))
    assert opened == [1, 1]
    names = [n for n, _, _ in trace.snapshot()["timeline"]["setup"]]
    assert names == ["yagi.device", "yagi.fake.create"] * 2


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_each_entrys_create_resolves_its_device_outside_its_span(entry, monkeypatch):
    seen = []
    resolve = device_mod.resolve_device

    def spy(device=None):
        seen.append([s.name for s in trace._stack()])
        return resolve(device)

    monkeypatch.setattr(device_mod, "resolve_device", spy)
    ENTRIES[entry][0](device=DEV)
    assert seen[0] == []  # the first resolve: no span open, the create's neither
