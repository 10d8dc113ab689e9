"""The port's own tracing (``yagi_tpu_torch.trace``): off it hands every site
one shared no-op and keeps nothing; on it keeps counts, times and self times
by name, each span's time taken from its parent's self time on its own
thread; set-up spans and counters record either way; the entries' outputs and
state are the same with it on or off; nothing reaches a profiler's trace; the
registry lists every kernel wrapper."""

import dataclasses
import importlib
import threading

import pytest
import torch

from yagi_tpu_torch import trace
from yagi_tpu_torch.chains import FusedRxChain, QamRx

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
