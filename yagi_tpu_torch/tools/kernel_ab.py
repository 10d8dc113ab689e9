"""A/B of a kernel's versions on one card: an earlier version (v1) against
the package's own (v2), for ``qam_eq_scan`` (``csrc/qam.cu``), K3
``symsync_fused`` and K4 ``symsync_scan`` (``csrc/symscan.cu``), ``agc_scan``
(``csrc/agc.cu``), K2, the channelizer (``csrc/channelizer.cu``), ``iir_scan``
and ``iir_chunked`` (``csrc/iir.cu``, body ``csrc/iir.cuh``), and K1, the
fused chain (``csrc/chain.cu``), where a third version runs too: the
two-stage formulation of ``tools/variants/chain_twostage.cu``. It is the
card's counterpart of ``tools/kernel_variants.py``, the TPU A/B of K1's
formulations.

v1's sources sit in a directory of their own, taken from the commit to
compare against, for example::

    mkdir -p build/ab_v1
    for f in agc.cu chain.cu channelizer.cu iir.cu iir.cuh nco.cuh qam.cu resamp.cu symscan.cu \
             symscan.cuh; do
        git show <commit>:yagi_tpu_torch/csrc/$f > build/ab_v1/$f
    done
    python -m yagi_tpu_torch.tools.kernel_ab --v1 build/ab_v1 [--only channelizer,iir_scan]

A directory with only some of the sources runs only their cases, and
``--only`` keeps the cases whose names contain one of its words. Each version
is built into its own library (``kernels/_build.py``), and the kernel
wrappers are pointed at it in turn. At each path's shape (config[3]:
``agc_scan`` on 2048 channels × 4096 samples, ``qam_eq_scan`` on 2048
channels × 8192 slots from K3, and K3 at k_out = 2; config[1]: K3 and K4 at
C = 1024, n = 3976, n_valid = 3965; K3 also at config[3]'s bank and shape
with one slot a sample (E = 1), where nearly every slot emits and none is
voted on (K3 votes past a sample's first slot): the worst case of the skip,
the loop's other changes alone; K4 also
at the bank past K3's shared memory, 64 filters of 176 taps, on 1024
channels × 1024 samples; config[4]:
K2 at M = 64, T = 2^15, p = 8; config[0]: K1 on 16 channels × 2^17
samples, on planes and on complex64; config[2]: ``iir_scan`` and
``iir_chunked`` on the de-emphasis, [512, 2^14] float32, and on the
4-section Butterworth lowpass (order 8, cutoff 0.1) at the same shape;
random input from a seed) every version's outputs and new state are first
held against v1's, bit for bit for the loops (``iir_scan`` among them),
within 1e-4 of |a| + 1e-3 for K1, within 1e-4 of the block's rms for K2
(whose outputs, rms ~11, come within 0.01 of 0, where the per-sample
criterion reads ~1e-3 with no fault), and within max |a − b| / max |b| of
2e-5 (TF) or 1e-4 (SOS) for ``iir_chunked`` (another summation order), then
each is timed by CUDA-graph replay in turns, v1, v2, v2, v1. v1's sources
share the package's C interface (``kernels/_build.py``'s signatures), since
every version runs through the package's kernel wrappers. Another variant of a
kernel (a lane count, a tile size) is an edited copy of its source in a
directory of its own, taken as v1. The shapes and constructors are those of
:mod:`.paths`, which ``chip_smoke.py`` uses too. Prints one line per
measurement and, last, one JSON object, which ``--out`` also receives.

One more case, ``resamp_u32 config[1]``, holds the u32 PFB resampler's kernel
(``csrc/resamp.cu``), v2's and v1's where v1 has one, against its torch path
(``kernels.resamp.resamp_u32_reference``) at config[1]'s block, 1024 × 4096:
the count, phase and window exact, y within 1e-6 of the rms; then times them
by graph replay in turns, plain, v1, v2, v2, v1, plain (``--only resamp``
builds no other case's inputs).

Where the package's library has K2's FM instance (``yagi_channelizer_fm``),
one more case holds it, and v1's where v1 has one, against its plain version
on that library, K2's plain instance and the torch discriminator
(``kernels.channelizer.fm_reference``) with the state's copies, at config[4]'s
block: the channels and the state bit for bit, fm within 1e-6, then all timed
in turns, plain, v1, v2, v2, v1, plain.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..chains import FusedRxChain
from ..design import iir as iirdes
from ..filter import IirFilter, Symsync
from ..kernels import _build
from ..kernels.agc import agc_scan_apply
from ..kernels.chain import fused_chain_apply, fused_chain_apply_c64
from ..kernels.channelizer import fused_channelizer_apply
from ..kernels.qam import qam_eq_scan_apply
from ..kernels.resamp import resamp_u32_apply, resamp_u32_reference
from ..kernels.symscan import branch_outputs, symsync_fused_apply, symsync_scan_apply
from ..kernels.iir import iir_chunked_apply, iir_scan_apply
from .paths import (C0, C1, C2, C3, CHAIN, M4, T0, T1, T2, T3, T4, chzfm_calls,
                    complex_block, make_channelizer, make_fmstereo, make_fused, make_msresamp,
                    make_qamrx, make_symsync)
from .timing import graph_ms

REPS = 10
CHAIN_TOL = 1e-4  # K1's versions against v1: |a − b| / (|a| + 1e-3)
CHZ_TOL = ("rms", 1e-4)  # K2's versions against v1: max |a − b| / rms(v1)
# iir_chunked's versions against v1: max |a − b| / max |v1| (chip_smoke.py's
# IIR_TF_TOL, IIR_SOS_TOL)
IIR_TF_TOL, IIR_SOS_TOL = ("max", 2e-5), ("max", 1e-4)
N_ROT = 4  # IIR input sets: 134 MB, more than the 50 MB L2 holds
GATE_BANK = dict(k=4, m=22, beta=0.3, num_filters=64)  # L = 176: past K3's shared memory
GATE_SHAPE = (1024, 1024)  # (C, n) of K4's case at that bank: 1.07 GB of stream
VARIANTS = Path(__file__).resolve().parent / "variants"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the package's C entry points and, beside them, variants/chain_twostage.cu's:
SIGNATURES = {
    **_build._SIGNATURES,
    # xr, xi, h, br, hist_r, hist_i, theta0, dtheta, yr, yi, C, T, P, n_taps, L, stream
    "yagi_chain_twostage": [_P] * 10 + [_I] * 5 + [_P],
}
TURNS = ("v1", "v2", "v2", "v1")
FM_CASE = "channelizer fm epilogue config[4]"  # the FM instance against its plain version
FM_TOL = 1e-6  # |fm − plain|: two float32 ulps of |fm| ≤ 5
RESAMP_CASE = "resamp_u32 config[1]"  # the resampler's kernel against its torch path
RESAMP_TOL = 1e-6  # max |y − plain| over the plain output's rms: float32 sums in two orders
CHAIN_TURNS = ("v1", "v2", "twostage", "twostage", "v2", "v1")


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
    if isinstance(out, torch.Tensor):
        return [out]
    tensors = []
    for v in out:
        tensors += list(v.values()) if isinstance(v, dict) else [v]
    return tensors


def chain_calls(device, rng):
    """K1's calls at config[0]. Each looks at the library the wrappers point
    at: the package's entry points go through the wrappers, the two-stage
    variant's through ctypes."""
    chain = make_fused(C0, device)
    p = chain.p
    h_fir, branches = FusedRxChain.design_filters(CHAIN["n_taps"], CHAIN["fc"], CHAIN["as_"],
                                                  m=7, npfb=256)
    h = np.zeros(64, np.float32)
    h[: len(h_fir)] = h_fir * (2.0 * CHAIN["fc"])
    br = np.zeros((p, 16), np.float32)
    br[:, : branches.shape[1]] = branches[:: 256 // p]
    h, br = torch.from_numpy(h).to(device), torch.from_numpy(br).to(device)
    theta0 = torch.tensor(0x9E3779B9, dtype=torch.int64, device=device)

    def planar(xr, xi, hr, hi):
        lib = _build.library()
        if not hasattr(lib, "yagi_chain_twostage"):
            return fused_chain_apply(xr, xi, chain.g, hr, hi, theta0, chain.d_theta, p=p,
                                     taps=chain.taps)
        C, T = xr.shape  # the two-stage variant has no wrapper
        yr = torch.empty((C, T * p), dtype=torch.float32, device=device)
        yi = torch.empty_like(yr)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.yagi_chain_twostage(
            xr.data_ptr(), xi.data_ptr(), h.data_ptr(), br.data_ptr(), hr.data_ptr(),
            hi.data_ptr(), theta0.data_ptr(), chain.d_theta.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), C, T, p, CHAIN["n_taps"], branches.shape[1], stream)
        if rc != 0:
            raise RuntimeError(f"chain variant launch failed with CUDA error {rc}")
        return yr, yi

    def c64(x, hr, hi):
        return fused_chain_apply_c64(x, chain.g, hr, hi, theta0, chain.d_theta, p=p,
                                     taps=chain.taps)

    def f32(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    sets = [(f32((C0, T0)), f32((C0, T0)), f32((C0, 128)), f32((C0, 128))) for _ in range(4)]
    csets = [(torch.complex(a[0], a[1]), a[2], a[3]) for a in sets]
    return ([lambda a=a: planar(*a) for a in sets] * 5, [lambda a=a: c64(*a) for a in csets] * 5,
            f"C={C0}, T={T0}, P={p}, Kp={chain.taps.shape[1]}")


def channelizer_calls(device, rng):
    """K2's calls at config[4]: four input sets (64 MB, more than L2 holds)."""
    fz = make_channelizer(device)
    n, nh = T4 * M4, fz.hist_r.shape[0]

    def f32(k):
        return torch.from_numpy(rng.standard_normal(k, dtype=np.float32)).to(device)

    sets = [(f32(n), f32(n), fz.taps, fz.hr, fz.hi, f32(nh), f32(nh)) for _ in range(4)]
    return ([lambda a=a: fused_channelizer_apply(*a, p=fz.p, r2=fz.r2) for a in sets] * 5,
            f"M={M4}, T={T4}, p={fz.p}")


def scan_calls(ss, c: int, n: int, n_valid, device, rng):
    """K4's calls on two streams from branch_outputs of random input through
    bank ``ss``."""
    L = ss.mf.shape[1]
    kw = dict(E=2, **ss.kernel_args())
    loop = [kw.pop(k) for k in ("state", "locked", "radj", "pll_a", "pll_b")]
    xs4 = [branch_outputs(complex_block(rng, (c, n + L), device), ss.taps()) for _ in range(2)]
    return [lambda x=x: symsync_scan_apply(x, n_valid, *loop, **kw) for x in xs4]


def iir_cases(device, rng) -> list:
    """The IIR kernels at config[2]'s shape, [C2, T2] float32 from a nonzero
    state: the de-emphasis (TF [α], [1, −(1 − α)]) and the 4-section
    Butterworth lowpass (order 8, cutoff 0.1) of chip_smoke.py's checks."""
    deemph = make_fmstereo(1, device).deemph_l
    bw = IirFilter.create_prototype(iirdes.IirFilterShape.BUTTER, iirdes.IirBandType.LOWPASS,
                                    iirdes.IirFormat.SECOND_ORDER_SECTIONS, 8, 0.1, device=device)

    def f32(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)

    out = []
    for f, sos, tol, tag in ((deemph, False, IIR_TF_TOL, "config[2]"),
                             (bw, True, IIR_SOS_TOL, "sos")):
        v_shape = (C2, bw.nsos, 2) if sos else (C2, 1)
        sets = [(f32((C2, T2)), f.b, f.a, f.scale, 0.5 * f32(v_shape)) for _ in range(N_ROT)]
        note = (f"C={C2}, T={T2}, float32, " + (f"SOS {bw.nsos} sections" if sos else "TF order 1"))
        for apply, name, entry, t in ((iir_chunked_apply, "iir_chunked", "yagi_iir_chunked", tol),
                                      (iir_scan_apply, "iir_scan", "yagi_iir_scan", None)):
            calls = [lambda s=s, f=apply, q=sos: f(*s, sos=q) for s in sets] * 5
            out.append((f"{name} {tag}", entry, calls, note, t, TURNS))
    return out


def cases(device, only=()):
    """(name, the C entry point a library needs for it, [calls per input
    set], shape note, the tolerance against v1 or None for bit identity, the
    versions in turns): each call runs one kernel launch on a fixed input.
    With ``only`` naming IIR cases alone, the other paths' inputs are not
    built."""
    if only and all(w.startswith("resamp") for w in only):
        return []  # RESAMP_CASE alone, which resamp_case builds
    iir = iir_cases(device, np.random.default_rng(6))
    if only and all(w.startswith("iir") for w in only):
        return iir
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
    k3_e1 = [lambda a=a: symsync_fused_apply(*a, None, **{**kw3, "E": 1}) for a in sets3]
    eq = [lambda s=s: qam_eq_scan_apply(*s, *eq_args, k_eq=rx.k_eq) for s in slots]
    a = rx.agc  # the path's AGC: bandwidth 1e-3, squelch disabled
    agc = [lambda x=x: agc_scan_apply(x, a.g, a.y2_prime, a.alpha, a.scale, a.squelch_threshold,
                                      a.locked, a.squelch_mode, a.squelch_timer, timeout=100)
           for x in (complex_block(rng, (C3, T3), device) for _ in range(2))]
    planar, c64, chain_note = chain_calls(device, rng)
    chz, chz_note = channelizer_calls(device, rng)
    k4_1 = scan_calls(ss1, C1, n1, nv, device, rng)
    gate = Symsync.create_rnyquist("rrcos", **GATE_BANK, batch_shape=(GATE_SHAPE[0],),
                                   device=device).set_lf_bw(0.02)
    k4_gate = scan_calls(gate, *GATE_SHAPE, None, device, rng)
    return [
        ("channelizer config[4]", "yagi_channelizer_fp32", chz, chz_note, CHZ_TOL, TURNS),
        ("symsync_scan config[1]", "yagi_symsync_scan", k4_1,
         f"C={C1}, n={n1}, n_valid={n1 - 11}, P={ss1.npfb}, E=2, k_out=1", None, TURNS),
        ("symsync_scan gate bank", "yagi_symsync_scan", k4_gate,
         f"C={GATE_SHAPE[0]}, n={GATE_SHAPE[1]}, L={gate.mf.shape[1]}, P={gate.npfb}, E=2",
         None, TURNS),
        ("symsync_fused config[1]", "yagi_symsync_fused_counted", k3_1,
         f"C={C1}, n={n1}, n_valid={n1 - 11}, L={L}, E=2, k_out=1", None, TURNS),
        ("symsync_fused config[3]", "yagi_symsync_fused_counted", k3_3,
         f"C={C3}, n={T3}, L={L}, E=2, k_out=2", None, TURNS),
        ("symsync_fused E=1 config[3]", "yagi_symsync_fused_counted", k3_e1,
         f"C={C3}, n={T3}, L={L}, E=1, k_out=2: nearly every slot emits", None, TURNS),
        ("qam_eq_scan config[3]", "yagi_qam_eq_scan_counted", eq,
         f"C={C3}, S={2 * T3}, M={eq_args[0].shape[0]}, h_len={rx.eq.h_len}", None, TURNS),
        ("agc_scan config[3]", "yagi_agc_scan", agc, f"C={C3}, n={T3}, squelch disabled", None,
         TURNS),
        ("chain planar config[0]", "yagi_chain_", planar, chain_note, CHAIN_TOL, CHAIN_TURNS),
        ("chain complex64 config[0]", "yagi_chain_c64", c64, chain_note, CHAIN_TOL, TURNS),
        *iir,
    ]


def fm_epilogue_case(device, libs) -> dict:
    """K2's FM instance of v2, and of v1 where v1 has one, against its plain
    version on v2's library (the plain instance, the torch discriminator and
    the state's copies) at config[4]'s block: the channels and the state bit
    for bit, fm within FM_TOL; then timed by graph replay in turns, plain,
    v1, v2, v2, v1, plain."""
    fused, plain = chzfm_calls(device, T4, 4)
    versions = [v for v in ("v1", "v2") if serves(libs[v], "yagi_channelizer_fm")]
    with using(libs["v2"]):
        want = [p() for p in plain]
    gaps = {}
    for v in versions:
        with using(libs[v]):
            got = [f() for f in fused]
        for g, w in zip(got, want):
            if not all(torch.equal(a, b) for i, (a, b) in enumerate(zip(g, w)) if i != 2):
                raise SystemExit(f"kernel_ab: {FM_CASE}: {v}'s channels or state differ from "
                                 "the plain version's")
        gaps[v] = max(float((g[2] - w[2]).abs().max()) for g, w in zip(got, want))
        if gaps[v] > FM_TOL:
            raise SystemExit(f"kernel_ab: {FM_CASE}: {v}'s fm differs from the plain's by "
                             f"{gaps[v]}")
    turns = ("plain", *versions, *versions[::-1], "plain")
    times = []
    for v in turns:
        with using(libs["v2" if v == "plain" else v]):
            times.append(graph_ms((plain if v == "plain" else fused) * 5, reps=REPS))
    per = {v: [t for o, t in zip(turns, times) if o == v] for v in ("plain", *versions)}
    print(f"[ab] {FM_CASE} (M={M4}, T={T4}): channels and state bit for bit, largest |fm − "
          f"plain| {gaps}; ms per call in turns "
          + ", ".join(f"{o} {t:.4f}" for o, t in zip(turns, times)))
    return {"shape": f"M={M4}, T={T4}", "fm_gap": gaps, "ms": per,
            "mean_ms": {v: sum(ts) / len(ts) for v, ts in per.items()}}


def resamp_case(device, libs) -> dict:
    """The u32 PFB resampler's kernel of v2, and of v1 where v1 has one,
    against its torch path (``resamp_u32_reference``, the frame gather and
    contraction) at config[1]'s block, 1024 × 4096 complex64 in four input
    sets (134 MB), from its state at create: the count, the phase and the
    window exact, y within RESAMP_TOL of the rms and 0 past the count; then
    timed by graph replay in turns, plain, v1, v2, v2, v1, plain."""
    ms = make_msresamp(C1, device)
    rs, cap = ms.arbitrary, ms.out_capacity(T1)
    rng = np.random.default_rng(7)
    nv = torch.tensor(T1, device=device)  # a device count: the torch path captures
    sets = [(complex_block(rng, (C1, T1), device), complex_block(rng, (C1, rs.sub_len), device))
            for _ in range(4)]

    def calls(fn):
        return [lambda s=s: fn(*s, rs.branches, rs.phase, rs.step, nv, out_capacity=cap)
                for s in sets]

    kernel, plain = calls(resamp_u32_apply), calls(resamp_u32_reference)
    versions = [v for v in ("v1", "v2") if serves(libs[v], "yagi_resamp_u32")]
    want = [p() for p in plain]
    gaps = {}
    for v in versions:
        with using(libs[v]):
            got = [k() for k in kernel]
        gap = 0.0
        for g, w in zip(got, want):
            c = int(w[1])
            exact = (int(g[1]) == c and int(g[2]) == int(w[2])
                     and torch.equal(torch.view_as_real(g[3]), torch.view_as_real(w[3])))
            if not exact or torch.view_as_real(g[0])[:, c:].view(torch.int32).any():
                raise SystemExit(f"kernel_ab: {RESAMP_CASE}: {v}'s count, phase, window or "
                                 "zeros differ from the plain version's")
            rms = w[0][:, :c].abs().square().mean().sqrt()
            gap = max(gap, float((g[0] - w[0]).abs().max() / rms))
        gaps[v] = gap
        if gap > RESAMP_TOL:
            raise SystemExit(f"kernel_ab: {RESAMP_CASE}: {v}'s y differs from the plain's by "
                             f"{gap} of the rms")
    turns = ("plain", *versions, *versions[::-1], "plain")
    times = []
    for v in turns:
        with using(libs["v2" if v == "plain" else v]):
            times.append(graph_ms((plain if v == "plain" else kernel) * 5, reps=REPS))
    per = {v: [t for o, t in zip(turns, times) if o == v] for v in ("plain", *versions)}
    shape = f"C={C1}, n={T1}, cap={cap}, L={rs.sub_len}, npfb={rs.npfb}"
    print(f"[ab] {RESAMP_CASE} ({shape}): count, phase and window exact, largest |y − plain| "
          f"over the rms {gaps}; ms per call in turns "
          + ", ".join(f"{o} {t:.4f}" for o, t in zip(turns, times)))
    return {"shape": shape, "y_gap": gaps, "ms": per,
            "mean_ms": {v: sum(ts) / len(ts) for v, ts in per.items()}}


def serves(lib, entry: str) -> bool:
    """Whether a library has the entry point (for K1: any of its forms)."""
    names = (("yagi_chain_planar", "yagi_chain_twostage")
             if entry == "yagi_chain_" else (entry,))
    return any(hasattr(lib, n) for n in names)


def agrees(got, want, tol):
    """Bit identity (``tol`` None); or the largest |a − b| / (|b| + 1e-3)
    (``tol`` a number), max |a − b| over the rms of b (``tol`` ("rms",
    bound)) or over max |b| (``tol`` ("max", bound)), where it stays below
    the bound, and False where it does not."""
    if tol is None:
        return all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
    def cplx(t):  # a (re, im) pair of planes as complex values
        planes = len(t) == 2 and not t[0].is_complex() and t[0].shape == t[1].shape
        return [torch.complex(*t)] if planes else t

    if isinstance(tol, tuple):
        kind, tol = tol
        scale = ((lambda b: b.abs().square().mean().sqrt()) if kind == "rms"
                 else (lambda b: b.abs().max()))
        worst = max(float((a - b).abs().max() / scale(b))
                    for g, w in zip(got, want) for a, b in zip(cplx(g), cplx(w)) if b.numel())
        print(f"[ab] largest difference from v1 over its {kind}: {worst:.3e}")
    else:
        worst = max(float(((a - b).abs() / (b.abs() + 1e-3)).max())
                    for g, w in zip(got, want) for a, b in zip(cplx(g), cplx(w)))
        print(f"[ab] largest relative difference from v1: {worst:.3e}")
    return worst < tol and worst


def build_log_lines(log: str) -> list[str]:
    keep = ("qam_eq_scan", "symsync_", "agc_scan", "chain_", "channelizer", "iir_", "resamp_",
            "registers", "spill")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--v1", required=True, help="directory with v1's sources")
    parser.add_argument("--out", default="build/kernel_ab.json")
    parser.add_argument("--only", default="",
                        help="comma-separated words: run only the cases whose names hold one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device; torch sees none")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[ab] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    builds = {"v1": _build.build(Path(args.v1)), "v2": _build.build(),
              "twostage": _build.build(VARIANTS)}
    for name, (path, log) in builds.items():
        print(f"[ab] {name}: {path.name}")
        for ln in build_log_lines(log):
            print(f"[ab] {name} build: {ln}")
    libs = {name: _build.bind(path, SIGNATURES) for name, (path, _) in builds.items()}

    result = {"card": card, "cases": {}}
    only = [w for w in args.only.split(",") if w]
    for name, entry, calls, note, tol, turns in cases(device, only):
        if only and not any(w in name for w in only):
            continue
        if not serves(libs["v1"], entry):
            print(f"[ab] {name}: v1 has no {entry}, skipped")
            continue
        versions = list(dict.fromkeys(turns))
        with using(libs["v1"]):
            want = [flat(call()) for call in calls[:4]]
        same = {}
        for v in versions:
            with using(libs[v]):
                got = [flat(call()) for call in calls[:4]]
            torch.cuda.synchronize()
            same[v] = agrees(got, want, tol)
        times = []
        for v in turns:
            with using(libs[v]):
                times.append(graph_ms(calls, reps=REPS))
        per = {v: [t for o, t in zip(turns, times) if o == v] for v in versions}
        held = "bit-identical to v1" if tol is None else f"within {tol} of v1"
        print(f"[ab] {name} ({note}): {held} {same}; ms per call in turns "
              + ", ".join(f"{o} {t:.4f}" for o, t in zip(turns, times)))
        result["cases"][name] = {"shape": note, "same_as_v1": same, "ms": per,
                                 "mean_ms": {v: sum(ts) / len(ts) for v, ts in per.items()}}
        if any(v is False for v in same.values()):
            raise SystemExit(f"kernel_ab: {name}: a version differs from v1: {same}")
    if (not only or any(w in FM_CASE for w in only)) and serves(libs["v2"], "yagi_channelizer_fm"):
        result["cases"][FM_CASE] = fm_epilogue_case(device, libs)
    if not only or any(w in RESAMP_CASE for w in only):
        result["cases"][RESAMP_CASE] = resamp_case(device, libs)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
