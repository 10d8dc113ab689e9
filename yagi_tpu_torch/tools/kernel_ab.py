"""A/B of two loop kernels on one card, ``qam_eq_scan`` (``csrc/qam.cu``)
and K3 ``symsync_fused`` (``csrc/symscan.cu``): an earlier version (v1)
against the package's own (v2).

v1's sources sit in a directory of their own, taken from the commit to
compare against, for example::

    mkdir -p build/ab_v1
    for f in qam.cu symscan.cu symscan.cuh; do
        git show <commit>:yagi_tpu_torch/csrc/$f > build/ab_v1/$f
    done
    python -m yagi_tpu_torch.tools.kernel_ab --v1 build/ab_v1

Each version is built into its own library (``kernels/_build.py``), and the
kernel wrappers are pointed at it in turn. At each path's shape (config[3]:
``qam_eq_scan`` on 2048 channels × 8192 slots from K3, and K3 at k_out = 2,
C = 2048, n = 4096; config[1]: K3 at C = 1024, n = 3976, n_valid = 3965,
random input from a seed) every version's outputs and new state are first
held bit for bit against v1's, then each is timed by CUDA-graph replay in
turns, v1, v2, v2, v1. Another variant of a kernel (a lane count, a loop
form) is an edited copy of its source in a directory of its own, taken as
v1. The shapes and constructors are those of :mod:`.paths`, which
``chip_smoke.py`` uses too. Prints one line per measurement and, last, one JSON object, which ``--out``
also receives.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..kernels import _build
from ..kernels.qam import qam_eq_scan_apply
from ..kernels.symscan import symsync_fused_apply
from .paths import C1, C3, T1, T3, complex_block, make_msresamp, make_qamrx, make_symsync
from .timing import graph_ms

REPS = 10


@contextlib.contextmanager
def using(lib):
    """Point the kernel wrappers at another build of the kernels."""
    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def flat(out) -> list:
    """A kernel's result as a list of tensors (outputs, then the state)."""
    tensors = []
    for v in out:
        tensors += list(v.values()) if isinstance(v, dict) else [v]
    return tensors


def cases(device):
    """(name, [calls per input set], shape note): each call runs one kernel
    launch through the wrappers on a fixed input."""
    rng = np.random.default_rng(5)
    ss1 = make_symsync(C1, device)
    n1 = make_msresamp(C1, device).out_capacity(T1)
    nv = torch.tensor(n1 - 11, device=device)
    kw1 = dict(E=2, **ss1.kernel_args())
    L = ss1.mf.shape[1]
    sets1 = [(complex_block(rng, (C1, n1 + L), device), ss1.taps()) for _ in range(4)]

    rx = make_qamrx(C3, device)
    kw3 = dict(E=rx.slots, **rx.symsync.kernel_args())
    sets3 = [(complex_block(rng, (C3, T3 + L), device), rx.symsync.taps()) for _ in range(2)]
    slots = []
    for a in sets3:
        y, v, _, _ = symsync_fused_apply(*a, None, **kw3)
        slots.append((y.reshape(C3, -1), v.reshape(C3, -1)))
    eq_args = rx.eq_scan_args()
    k3_1 = [lambda a=a: symsync_fused_apply(*a, nv, **kw1) for a in sets1]
    k3_3 = [lambda a=a: symsync_fused_apply(*a, None, **kw3) for a in sets3]
    eq = [lambda s=s: qam_eq_scan_apply(*s, *eq_args, k_eq=rx.k_eq) for s in slots]
    return [
        ("symsync_fused config[1]", k3_1, f"C={C1}, n={n1}, n_valid={n1 - 11}, L={L}, E=2, k_out=1"),
        ("symsync_fused config[3]", k3_3, f"C={C3}, n={T3}, L={L}, E=2, k_out=2"),
        ("qam_eq_scan config[3]", eq,
         f"C={C3}, S={2 * T3}, M={eq_args[0].shape[0]}, h_len={rx.eq.h_len}"),
    ]


def build_log_lines(log: str) -> list[str]:
    keep = ("qam_eq_scan", "symsync_fused", "registers", "spill")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--v1", required=True, help="directory with v1's qam.cu, symscan.cu(h)")
    parser.add_argument("--out", default="build/kernel_ab.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device; torch sees none")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[ab] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    builds = {"v1": _build.build(Path(args.v1)), "v2": _build.build()}
    for name, (path, log) in builds.items():
        print(f"[ab] {name}: {path.name}")
        for ln in build_log_lines(log):
            print(f"[ab] {name} build: {ln}")
    libs = {name: _build.bind(path) for name, (path, _) in builds.items()}
    order = ["v1", "v2", "v2", "v1"]

    result = {"card": card, "order": order, "cases": {}}
    for name, calls, note in cases(device):
        with using(libs["v1"]):
            want = [flat(call()) for call in calls]
        same = {}
        for v, lib in libs.items():
            with using(lib):
                got = [flat(call()) for call in calls]
            torch.cuda.synchronize()
            same[v] = all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
        times = []
        for v in order:
            with using(libs[v]):
                times.append(graph_ms(calls, reps=REPS))
        per = {v: [t for o, t in zip(order, times) if o == v] for v in libs}
        print(f"[ab] {name} ({note}): bit-identical to v1 {same}; ms per call in turns "
              + ", ".join(f"{o} {t:.4f}" for o, t in zip(order, times)))
        result["cases"][name] = {"shape": note, "same_as_v1": same, "ms": per,
                                 "mean_ms": {v: sum(ts) / len(ts) for v, ts in per.items()}}
        if not all(same.values()):
            raise SystemExit(f"kernel_ab: {name}: a version differs from v1: {same}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
