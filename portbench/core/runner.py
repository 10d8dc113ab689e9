"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

``run_cell`` does the work on any device (the tests drive it on the CPU);
``main`` is the command line, which refuses to run without the cards the
cell asks for and refuses to print a result if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field

from . import registry, trace as trace_mod, window
from .stats import bound_s

# whole top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "yagi_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own library already builds into ``build/yagi_tpu_torch``)."""
    build = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.splitlines()[0]
        name, limit = (s.strip() for s in out.split(","))
        return {"smi_name": name, "power_limit_w": float(limit)}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {}


@dataclass
class Record:
    """What a run measured, for the metric readers (``end_to_end/*.py``,
    ``layer_metrics/*.py``, each ``read(record) -> float | None``)."""

    config: dict
    workload: dict
    samples_per_block: int
    setup_s: float
    window: window.Window
    peaks: dict | None  # this device's row of peaks.json, if it has one
    port_kernels: tuple = ()  # names of the port's own CUDA kernels
    slice: trace_mod.Slice | None = None
    info: dict = field(default_factory=dict)  # what the check counted (emissions, ...)

    def work(self, function: str):
        """(bytes, operations) of ``work/<function>.py`` at this cell's
        shapes, or None where it cannot count them."""
        return registry.module("work", function).work(self.config, self.workload, self.info)

    def kernel_s_per_call(self, pattern: str) -> float | None:
        """Mean device seconds of the traced ops whose name matches."""
        if self.slice is None:
            return None
        ops = self.slice.matching(pattern)
        return sum(o.end - o.start for o in ops) / len(ops) if ops else None

    def roofline_pct(self, kernel_pattern: str, function: str) -> float | None:
        """100 × the least time of ``function``'s work over the kernel's
        device time per call."""
        t = self.kernel_s_per_call(kernel_pattern)
        work = self.work(function)
        if t is None or work is None or self.peaks is None:
            return None
        return 100.0 * bound_s(work, self.peaks) / t


def port_kernel_names() -> tuple:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for src in (registry.ROOT / "yagi_tpu_torch" / "csrc").glob("*.cu"):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                src.read_text()))
    return tuple(sorted(names))


@dataclass
class Result:
    line: dict
    checks: dict  # name -> (value, limit)
    correct: bool


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, step_wrapper=None, control: bool = False,
             resize: dict | None = None) -> Result:
    """One run of ``cell_name`` on ``device``. For tests: ``step_wrapper(step)``
    replaces the entry with a broken one; ``resize`` overrides sizes of the
    configuration (``channels``) and the workload (the rest). ``control``
    judges the reference in lower precision in the program's place."""
    entry = registry.cell(bench, cell_name)
    wl = registry.data("workloads", cell_name)
    cfg = registry.data("configs", wl["config"])
    for key, value in (resize or {}).items():
        (cfg if key == "channels" else wl)[key] = value
    driver = registry.module("drivers", cfg["driver"]).Driver(cfg, wl, device)
    ref = registry.module("reference", cfg["driver"])
    blocks = registry.module("signals", wl["signal"]).make(cfg, wl, seed, device)
    dev = window.Device(device)
    step = driver.step if step_wrapper is None else step_wrapper(driver.step)

    # set-up: the first blocks of the stream warm up every shape the window uses
    state = driver.initial_state()
    start = None
    for i in range(wl["warmup_blocks"]):
        out, new = step(state, blocks[i % len(blocks)])
        if i == 0:
            start = window.Kept(0, state, out, new)
        state = new
    dev.synchronize()
    setup_s = time.time() - t_start

    keeper = window.Keeper(wl["check_blocks"], seed)
    win = window.run(step, state, blocks, wl["warmup_blocks"], seconds, dev, keeper,
                     in_flight=wl["in_flight"], trace_steps=wl["trace_steps"] if trace else 0)
    peak = dev.memory_peak()
    kind = dev.kind()
    sl = trace_mod.read(win.trace, win.trace_steps) if win.trace is not None else None
    win.trace = None
    state = win.state = None
    view = driver.view
    del driver

    def viewed(k):
        return window.Kept(k.index, view(k.before), k.out, view(k.after))

    per_block, info = ref.check(cfg, wl, blocks, viewed(start), [viewed(k) for k in keeper.kept],
                                device, control=control)
    limits = cfg["limits"]
    checks = {name: (max(b[name] for b in per_block), limit) for name, limit in limits.items()}
    failed = sum(any(not b[name] <= limit for name, limit in limits.items()) for b in per_block)
    correct = failed == 0

    peaks = json.loads((registry.PKG / "peaks.json").read_text()).get(kind)
    rec = Record(config=cfg, workload=wl, samples_per_block=cfg["channels"] * wl["block"],
                 setup_s=setup_s, window=win, peaks=peaks, port_kernels=port_kernel_names(),
                 slice=sl, info=info)
    metrics = {}
    for m in registry.metrics_of(bench, cell_name, trace):
        kind_dir = "layer_metrics" if trace else "end_to_end"
        value = registry.module(kind_dir, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
                "count": entry["chips"], "memory_peak_bytes": peak}
    if sl is not None:
        dev_info.update(busy_s=sl.busy_s(), window_s=sl.wall_s)
    if device.type == "cuda":
        dev_info.update(card_info())
    # failed: the compared blocks (the stream's first and the sample of the window's) that fail
    line = {"correct": correct, "attempted": win.blocks, "failed": failed, "metrics": metrics,
            "device": dev_info}
    if sl is not None:
        line["breakdown"] = sl.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return Result(line=line, checks=checks, correct=correct)


def main(argv, root) -> int:
    t_start = process_start()
    parser = argparse.ArgumentParser(prog="portbench/run.py",
                                     description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs(root)
    bench = registry.benchmark(root)
    chips = registry.cell(bench, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    # float32 as configured: no TF32 in any matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, (value, limit) in res.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res.line), flush=True)
    return 0
