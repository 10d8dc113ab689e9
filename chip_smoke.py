#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

Three paths of the port, yagi_tpu_torch, each at its real size:

* BASELINE config[0]: 64-tap Kaiser FIR → 2× polyphase interpolator → u32
  NCO mix-down, 16 channels, blocks of 2^17 complex samples (FusedRxChain,
  kernel K1, csrc/chain.cu);
* BASELINE config[4]: 64-channel polyphase channelizer (Kaiser prototype,
  m = 4, 60 dB) → FM discriminator (kf = 0.1) per channel, blocks of 2^21
  complex samples (FusedChannelizer → Freqdem, kernel K2,
  csrc/channelizer.cu);
* the u32 NCO mix-down of blocks of 2^21 complex samples, phase carried
  (mix_down_apply, kernel K5, csrc/mix.cu);
* BASELINE config[1]: arbitrary-rate MsResamp (rate 2/2.0663, "farrow",
  whose decimation stage is the 256-branch PFB gather) → Symsync (RRCOS
  k = 2, m = 7, β = 0.3, 32 filters, loop bandwidth 0.02) over 1024
  channels, blocks of 4096 complex samples, the resampler's count fed on as
  n_valid (kernel K3 for backend "auto", K4 for "pallas", csrc/symscan.cu).

Five phases:

1. device: the card's name and power limit;
2. build: the CUDA kernels, compiled with nvcc from this checkout;
3. kernel vs plain: each kernel against its plain torch version on the same
   CUDA tensors, at a small shape and at its path's shape;
4. main paths: each streams 16 blocks with its state carried, held against
   the plain oracle (RxChain, Firpfbch → Freqdem, Osc.mix_block_down, and
   for config[1] the XLA-form scan over its first 4 blocks); every launch
   count is set to 0 just before a path and read just after it;
   block-split invariance;
5. timing with CUDA events: each kernel by CUDA-graph replay, each plain
   version by graph replay (eager calls for the symsync scans' plain
   loops), and the config[0], config[4] and config[1] steps.

Prints one line per check, a JSON line of per-kernel results, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits non-zero; so does a machine without a
CUDA device. Run it from anywhere: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from yagi_tpu_torch._src.struct import U32  # noqa: E402
from yagi_tpu_torch.chains import FusedRxChain, RxChain  # noqa: E402
from yagi_tpu_torch.kernels import _build  # noqa: E402
from yagi_tpu_torch.kernels.chain import (  # noqa: E402
    fused_chain_apply,
    fused_chain_reference,
)
from yagi_tpu_torch.kernels.channelizer import (  # noqa: E402
    fused_channelizer_apply,
    fused_channelizer_reference,
)
from yagi_tpu_torch.filter import MsResamp, Symsync  # noqa: E402
from yagi_tpu_torch.kernels.mix import mix_down_apply, mix_down_reference  # noqa: E402
from yagi_tpu_torch.kernels.symscan import (  # noqa: E402
    branch_outputs,
    symsync_fused_apply,
    symsync_fused_reference,
    symsync_scan_apply,
    symsync_scan_reference,
)
from yagi_tpu_torch.modem import Freqdem  # noqa: E402
from yagi_tpu_torch.multichannel import Firpfbch, FusedChannelizer  # noqa: E402
from yagi_tpu_torch.nco import Osc  # noqa: E402

C, T = 16, 1 << 17  # config[0]: channels, samples per block
N_BLOCKS = 16
N_ROT = 4  # input sets cycled in the timing phase
CHAIN = dict(n_taps=64, fc=0.2, as_=60.0, rate=2.0)
MIX_FREQ = 0.35
SEED = 0
# the fused chain's combined taps are built in float64 and summed in another
# order than the staged chain: relative error below 1e-4 against |a| + 1e-3,
# as tests/test_fused_chain.py holds the TPU kernel
REL_TOL = 1e-4
SPLIT_ATOL = 1e-5

# config[4] (bench.py:85-125): 64 channels, 2^15 analyzer steps per block
M4, T4 = 64, 1 << 15
CHZ = dict(num_channels=M4, m=4, as_=60.0, r2=128)
KF = 0.1
# The channelizer's outputs have an rms of ~11 and fp32 sums leave ~1e-5 of
# absolute error, so error is held relative to the block's rms: at 2^21
# outputs a few lie within 0.01 of 0, where |a − b| / (|a| + 1e-3) reaches
# ~1e-3 without any fault (PERF.md). The per-sample figure is printed too.
CHZ_TOL = 1e-4
# FM outputs compare by wrapped phase (radians) where both discriminator
# inputs are at least 5% of the block's rms: arg() is ill-conditioned near 0
FM_TOL, FM_MAG = 1e-4, 0.05
# K5 (tests/test_native_kernels.py): |a − b| <= MIX_TOL·(1 + |b|)
N_MIX = 1 << 21
MIX_TOL = 1e-6
MIX_PHASE = 1.1

# config[1] (bench.py:160-192): 1024 channels, blocks of 4096
C1, T1 = 1024, 1 << 12
MS_RATE = 2.0 / 2.0663
SYM = dict(ftype="rrcos", k=2, m=7, beta=0.3)
LF_BW = 0.02
N_SYM_CHECK = 4  # config[1] blocks held against the XLA-form scan
N_PALLAS = 4  # config[1] blocks through K4
SYM_SPLIT = 2000  # where the block-split check cuts a resampled block
# K3 sums its dots in the order branch_outputs reproduces, and K4 and the
# XLA-form scan read branch_outputs' stream, so all three are held to bit
# identity (kernels/symscan.py says why one order: through the loop's
# feedback, dots an ulp apart part whole channels).

KERNELS = (fused_chain_apply, fused_channelizer_apply, mix_down_apply, symsync_fused_apply,
           symsync_scan_apply)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def read_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs() / (a.abs() + 1e-3)).max().item()


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over the rms of a."""
    return ((a - b).abs().max() / a.abs().square().mean().sqrt()).item()


def planes(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)


def fm_phase_err(fm_a, fm_b, y, y_prev_last) -> tuple[float, float]:
    """Largest wrapped phase difference (rad) between two FM outputs where
    both discriminator inputs have magnitude >= FM_MAG of the block's rms,
    and the share of samples that qualify."""
    mag = y.abs()
    mag_prev = torch.cat([y_prev_last.abs()[:, None], mag[:, :-1]], dim=1)
    floor = FM_MAG * mag.square().mean().sqrt()
    keep = (mag >= floor) & (mag_prev >= floor)
    d = torch.remainder((fm_a - fm_b).double() * (2 * np.pi * KF) + np.pi, 2 * np.pi) - np.pi
    return d.abs()[keep].max().item(), keep.double().mean().item()


def complex_block(rng, shape, device) -> torch.Tensor:
    re = rng.standard_normal(shape, dtype=np.float32)
    im = rng.standard_normal(shape, dtype=np.float32)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` in ms over ``iters`` eager calls, between
    CUDA events: device time, or host time where launching is the slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int = 10) -> float:
    """Mean device time per call in ms: the calls ``fns`` are captured once
    into a CUDA graph, which is replayed ``reps`` times, so host launch cost
    is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"[build] {path.name} in {dt:.2f} s ({' '.join(_build.NVCC_FLAGS)})")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[build] {line.strip()}")


def kernel_inputs(rng, c: int, t: int, mix_freq: float, device):
    """Arguments of fused_chain_apply with random planes and history and a
    nonzero start phase."""
    chain = FusedRxChain.create(**CHAIN, mix_freq=mix_freq, batch_shape=(c,), device=device)
    planes = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device)
              for s in [(c, t), (c, t), (c, 128), (c, 128)]]
    theta0 = torch.tensor(0x9E3779B9, dtype=torch.int64, device=device)
    xr, xi, hr, hi = planes
    return (xr, xi, chain.g, hr, hi, theta0, chain.d_theta), chain.p


def phase_kernel_vs_plain(device) -> float:
    """Kernel against fused_chain_reference; returns max |error| at config[0]."""
    rng = np.random.default_rng(SEED)
    max_abs = 0.0
    for c, t in [(3, 2048), (C, T)]:
        for mix in (0.0, MIX_FREQ):
            args, p = kernel_inputs(rng, c, t, mix, device)
            kr, ki = fused_chain_apply(*args, p=p)
            rr, ri = fused_chain_reference(*args, p=p)
            a, b = torch.complex(rr, ri), torch.complex(kr, ki)
            err = rel_err(a, b)
            abs_err = (a - b).abs().max().item()
            require(tuple(b.shape) == (c, t * p), f"kernel output shape {tuple(b.shape)}")
            require(bool(torch.isfinite(b).all()), "kernel output finite")
            print(f"[kernel-vs-plain] chain_fp32 C={c} T={t} mix={mix}: "
                  f"max rel err {err:.3e} (< {REL_TOL}), max abs err {abs_err:.3e}")
            require(err < REL_TOL, f"kernel vs plain at C={c} T={t} mix={mix}: {err}")
            if (c, t) == (C, T):
                max_abs = max(max_abs, abs_err)
    return max_abs


def phase_main_path(device) -> int:
    """Stream N_BLOCKS config[0] blocks through FusedRxChain; returns the
    kernel launches of that run."""
    rng = np.random.default_rng(SEED + 1)
    blocks = [complex_block(rng, (C, T), device) for _ in range(N_BLOCKS)]
    fused = FusedRxChain.create(**CHAIN, mix_freq=MIX_FREQ, batch_shape=(C,), device=device)
    rx = RxChain.create(**CHAIN, mix_freq=MIX_FREQ, batch_shape=(C,), device=device)

    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for x in blocks:
        y, k, fused = fused.step(x)
        outs.append((y, k))
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["fused_chain_apply"]
    print(f"[main-path] FusedRxChain: {N_BLOCKS} steps of [{C}, {T}] complex64, "
          f"kernel launches {counts}")
    require(launches == N_BLOCKS, f"launches {launches} != steps {N_BLOCKS}")

    worst = 0.0
    for i, (x, (y, k)) in enumerate(zip(blocks, outs)):
        y_ref, k_ref, rx = rx.step(x)
        k_ref = int(k_ref)
        require(k == k_ref == 2 * T, f"block {i}: counts {k}, {k_ref}, want {2 * T}")
        require(tuple(y.shape) == (C, 2 * T), f"block {i}: shape {tuple(y.shape)}")
        require(bool(torch.isfinite(y).all()), f"block {i}: finite output")
        err = rel_err(y_ref[:, :k_ref], y)
        require(err < REL_TOL, f"block {i}: fused vs RxChain rel err {err}")
        require(bool((y_ref[:, k_ref:] == 0).all()), f"block {i}: RxChain zero tail")
        worst = max(worst, err)
    print(f"[main-path] FusedRxChain vs RxChain over {N_BLOCKS} blocks: "
          f"max rel err {worst:.3e} (< {REL_TOL}), k = 2T = {2 * T}")

    # one 2T block equals two T blocks: the carried state is exact
    x2 = torch.cat(blocks[:2], dim=-1)
    mk = lambda: FusedRxChain.create(  # noqa: E731
        **CHAIN, mix_freq=MIX_FREQ, batch_shape=(C,), device=device)
    y_all, _, _ = mk().step(x2)
    y_a, _, c2 = mk().step(blocks[0])
    y_b, _, _ = c2.step(blocks[1])
    split = (y_all - torch.cat([y_a, y_b], dim=-1)).abs().max().item()
    print(f"[main-path] block split 2T vs T+T: max abs diff {split:.3e} (<= {SPLIT_ATOL})")
    require(split <= SPLIT_ATOL, f"block split {split}")
    return launches


def phase_timing(device, card: str) -> tuple[float, float]:
    """CUDA-event times at config[0]; returns (kernel ms, plain ms), both
    device time per call from graph replay."""
    rng = np.random.default_rng(SEED + 2)
    # N_ROT input sets (64 MB of input) so the 50 MB L2 cannot hold the
    # input between calls, as in a stream of fresh blocks
    sets = [kernel_inputs(rng, C, T, MIX_FREQ, device) for _ in range(N_ROT)]
    p = sets[0][1]
    kernel = [lambda a=a: fused_chain_apply(*a, p=p) for a, _ in sets] * 5
    plain = [lambda a=a: fused_chain_reference(*a, p=p) for a, _ in sets] * 5
    # alternate plain, kernel, kernel, plain so drift hits both alike
    p1, k1, k2, p2 = graph_ms(plain), graph_ms(kernel), graph_ms(kernel), graph_ms(plain)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    k_eager = cuda_ms(kernel[0], 200)
    print(f"[timing] {card}: chain_fp32 kernel {k_ms:.4f} ms/step ({k1:.4f}, {k2:.4f}); "
          f"fused_chain_reference {p_ms:.4f} ms/step ({p1:.4f}, {p2:.4f}); device time "
          f"from graph replay at [{C}, {T}] P={p}. Eager kernel calls: {k_eager:.4f} ms/call")

    blocks = [complex_block(rng, (C, T), device) for _ in range(N_ROT)]

    def chain_msps(chain, iters: int) -> float:
        state = [chain, 0]

        def step():
            _, _, state[0] = state[0].step(blocks[state[1] % N_ROT])
            state[1] += 1

        return C * T / (cuda_ms(step, iters) * 1e-3) / 1e6

    fused = FusedRxChain.create(**CHAIN, mix_freq=MIX_FREQ, batch_shape=(C,), device=device)
    rx = RxChain.create(**CHAIN, mix_freq=MIX_FREQ, batch_shape=(C,), device=device)
    f_msps = chain_msps(fused, 200)
    r_msps = chain_msps(rx, 20)
    print(f"[timing] {card}: FusedRxChain.step {f_msps:.1f} Msps, RxChain.step "
          f"{r_msps:.1f} Msps (input complex Msamples/s, eager steps of [{C}, {T}] blocks)")
    return k_ms, p_ms


def phase_kernel_vs_plain_channelizer(device) -> float:
    """K2 against fused_channelizer_reference with a random history; returns
    max |error| at config[4]."""
    rng = np.random.default_rng(SEED + 10)
    fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
    max_abs = 0.0
    for t in (256, T4):
        n, nh = t * M4, fz.hist_r.shape[0]
        args = (planes(rng, n, device), planes(rng, n, device), fz.taps, fz.hr, fz.hi,
                planes(rng, nh, device), planes(rng, nh, device))
        kr, ki = fused_channelizer_apply(*args, p=fz.p, r2=fz.r2)
        rr, ri = fused_channelizer_reference(*args, p=fz.p)
        a, b = torch.complex(rr, ri), torch.complex(kr, ki)
        require(tuple(b.shape) == (t, M4), f"channelizer output shape {tuple(b.shape)}")
        require(bool(torch.isfinite(b).all()), "channelizer output finite")
        err, abs_err = rel_rms(a, b), (a - b).abs().max().item()
        print(f"[kernel-vs-plain] channelizer_fp32 T={t} p={fz.p}: max abs err {abs_err:.3e} "
              f"= {err:.3e} of the rms (< {CHZ_TOL}); per-sample rel err (|a| + 1e-3) "
              f"{rel_err(a, b):.3e}")
        require(err < CHZ_TOL, f"channelizer kernel vs plain at T={t}: {err}")
        if t == T4:
            max_abs = abs_err
    return max_abs


def phase_kernel_vs_plain_mix(device) -> float:
    """K5 against mix_down_reference from a nonzero phase; returns max
    |error| at n = N_MIX."""
    rng = np.random.default_rng(SEED + 11)
    osc = Osc.create("exact", device=device).set_frequency(MIX_FREQ).set_phase(MIX_PHASE)
    max_abs = 0.0
    for n in (32768, N_MIX):
        x = complex_block(rng, (n,), device)
        y = mix_down_apply(x, osc.theta, osc.d_theta)
        ref = mix_down_reference(x, osc.theta, osc.d_theta)
        require(tuple(y.shape) == (n,) and y.dtype == torch.complex64, "mix-down output")
        abs_err = (y - ref).abs().max().item()
        over = ((y - ref).abs() - MIX_TOL * (1 + ref.abs())).max().item()
        print(f"[kernel-vs-plain] mix_down n={n} theta0={int(osc.theta)}: max abs err "
              f"{abs_err:.3e} (<= {MIX_TOL}·(1 + |a|))")
        require(over <= 0, f"mix-down kernel vs plain at n={n}: {abs_err}")
        max_abs = abs_err
    return max_abs


def phase_main_path_config4(device) -> int:
    """Stream N_BLOCKS config[4] blocks through FusedChannelizer → Freqdem;
    returns the K2 launches of that run."""
    rng = np.random.default_rng(SEED + 12)
    n = T4 * M4
    blocks = [(planes(rng, n, device), planes(rng, n, device)) for _ in range(N_BLOCKS)]
    fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
    dem = Freqdem.create(KF, batch_shape=(M4,), device=device)

    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for xr, xi in blocks:
        yr, yi, fz = fz.analyzer_execute_planar(xr, xi)
        fm, dem = dem.demodulate(torch.complex(yr, yi).T)  # channel-major view
        outs.append((yr, yi, fm))
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["fused_channelizer_apply"]
    print(f"[main-path] FusedChannelizer -> Freqdem: {N_BLOCKS} blocks of {n} complex "
          f"samples (M={M4}, T={T4}, kf={KF}), kernel launches {counts}")
    require(launches == N_BLOCKS, f"launches {launches} != blocks {N_BLOCKS}")

    ref = Firpfbch.create_kaiser(M4, CHZ["m"], CHZ["as_"], device=device)
    dem_ref = Freqdem.create(KF, batch_shape=(M4,), device=device)
    prev = torch.zeros(M4, dtype=torch.complex64, device=device)
    worst, worst_fm, kept = 0.0, 0.0, 1.0
    for i, ((xr, xi), (yr, yi, fm)) in enumerate(zip(blocks, outs)):
        y = torch.complex(yr, yi).T
        y_ref, ref = ref.analyzer_execute(torch.complex(xr, xi))
        fm_ref, dem_ref = dem_ref.demodulate(y_ref)
        require(tuple(y.shape) == tuple(fm.shape) == (M4, T4), f"block {i}: shapes")
        require(bool(torch.isfinite(y).all() & torch.isfinite(fm).all()), f"block {i}: finite")
        err = rel_rms(y_ref, y)
        require(err < CHZ_TOL, f"block {i}: FusedChannelizer vs Firpfbch {err}")
        fm_err, share = fm_phase_err(fm, fm_ref, y_ref, prev)
        require(fm_err <= FM_TOL, f"block {i}: FM phase error {fm_err} rad")
        worst, worst_fm, kept = max(worst, err), max(worst_fm, fm_err), min(kept, share)
        prev = y_ref[:, -1]
    print(f"[main-path] FusedChannelizer vs Firpfbch over {N_BLOCKS} blocks: max abs err "
          f"{worst:.3e} of the rms (< {CHZ_TOL}); FM vs Firpfbch -> Freqdem: max wrapped "
          f"phase err {worst_fm:.3e} rad (<= {FM_TOL}) over >= {kept:.4f} of the samples "
          f"(both inputs >= {FM_MAG} of the rms)")

    # one 2N block equals two N blocks: the carried state is exact
    def run(chunks):
        fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
        dem = Freqdem.create(KF, batch_shape=(M4,), device=device)
        ys, fms = [], []
        for xr, xi in chunks:
            yr, yi, fz = fz.analyzer_execute_planar(xr, xi)
            fm, dem = dem.demodulate(torch.complex(yr, yi).T)
            ys.append(torch.complex(yr, yi).T)
            fms.append(fm)
        return torch.cat(ys, dim=-1), torch.cat(fms, dim=-1)

    y_all, fm_all = run([(torch.cat([blocks[0][0], blocks[1][0]]),
                          torch.cat([blocks[0][1], blocks[1][1]]))])
    y_two, fm_two = run(blocks[:2])
    split = (y_all - y_two).abs().max().item()
    fm_split = (fm_all - fm_two).abs().max().item()
    print(f"[main-path] block split 2N vs N+N: channels max abs diff {split:.3e} "
          f"(<= {SPLIT_ATOL}), FM max abs diff {fm_split:.3e}")
    require(split <= SPLIT_ATOL, f"block split {split}")
    fm_err, _ = fm_phase_err(fm_all, fm_two, y_all, torch.zeros_like(prev))
    require(fm_err <= FM_TOL, f"FM block split {fm_err} rad")
    return launches


def phase_mix_path(device) -> int:
    """Stream N_BLOCKS blocks of N_MIX samples through mix_down_apply with
    the u32 phase carried; returns the K5 launches of that run."""
    rng = np.random.default_rng(SEED + 13)
    blocks = [complex_block(rng, (N_MIX,), device) for _ in range(N_BLOCKS)]
    osc = Osc.create("exact", device=device).set_frequency(MIX_FREQ).set_phase(MIX_PHASE)
    theta, dtheta = osc.theta, osc.d_theta

    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for x in blocks:
        outs.append(mix_down_apply(x, theta, dtheta))
        theta = (theta + N_MIX * dtheta) & U32
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["mix_down_apply"]
    print(f"[main-path] mix_down_apply: {N_BLOCKS} blocks of {N_MIX} complex samples, "
          f"phase carried, kernel launches {counts}")
    require(launches == N_BLOCKS, f"launches {launches} != blocks {N_BLOCKS}")

    worst = 0.0
    for i, (x, y) in enumerate(zip(blocks, outs)):
        y_ref, osc = osc.mix_block_down(x)
        require(bool(((y - y_ref).abs() <= MIX_TOL * (1 + y_ref.abs())).all()),
                f"block {i}: mix_down_apply vs Osc.mix_block_down")
        worst = max(worst, (y - y_ref).abs().max().item())
    require(int(theta) == int(osc.theta), "carried phase")
    print(f"[main-path] mix_down_apply vs Osc.mix_block_down over {N_BLOCKS} blocks: "
          f"max abs err {worst:.3e}; carried phase equal")
    return launches


def phase_timing_config4(device, card: str) -> tuple[float, float]:
    """config[4]: K2 and its plain version by graph replay, then the eager
    channelize → FM step; returns (kernel ms, plain ms)."""
    rng = np.random.default_rng(SEED + 14)
    fz = FusedChannelizer.create_kaiser(**CHZ, device=device)
    n, nh = T4 * M4, fz.hist_r.shape[0]
    # N_ROT input sets (64 MB) so the 50 MB L2 cannot hold the input
    sets = [(planes(rng, n, device), planes(rng, n, device), fz.taps, fz.hr, fz.hi,
             planes(rng, nh, device), planes(rng, nh, device)) for _ in range(N_ROT)]
    kernel = [lambda a=a: fused_channelizer_apply(*a, p=fz.p, r2=fz.r2) for a in sets] * 5
    plain = [lambda a=a: fused_channelizer_reference(*a, p=fz.p) for a in sets] * 5
    p1, k1, k2, p2 = graph_ms(plain), graph_ms(kernel), graph_ms(kernel), graph_ms(plain)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    k_eager = cuda_ms(kernel[0], 200)
    print(f"[timing] {card}: channelizer_fp32 kernel {k_ms:.4f} ms/block ({k1:.4f}, {k2:.4f}); "
          f"fused_channelizer_reference {p_ms:.4f} ms/block ({p1:.4f}, {p2:.4f}); device "
          f"time from graph replay at T={T4}, M={M4}, p={fz.p}. Eager kernel calls: "
          f"{k_eager:.4f} ms/call")

    cplx = [torch.complex(a[0], a[1]) for a in sets]

    def step_msps(chz, iters: int, complex_in: bool) -> float:
        state = [chz, Freqdem.create(KF, batch_shape=(M4,), device=device), 0]

        def step():
            i = state[2] % N_ROT
            if complex_in:
                y, state[0] = state[0].analyzer_execute(cplx[i])
            else:
                yr, yi, state[0] = state[0].analyzer_execute_planar(sets[i][0], sets[i][1])
                y = torch.complex(yr, yi).T
            _, state[1] = state[1].demodulate(y)
            state[2] += 1

        return n / (cuda_ms(step, iters) * 1e-3) / 1e6

    f_msps = step_msps(FusedChannelizer.create_kaiser(**CHZ, device=device), 100, False)
    r_msps = step_msps(Firpfbch.create_kaiser(M4, CHZ["m"], CHZ["as_"], device=device), 20, True)
    print(f"[timing] {card}: config[4] step FusedChannelizer -> Freqdem {f_msps:.1f} Msps, "
          f"Firpfbch -> Freqdem {r_msps:.1f} Msps (input complex Msamples/s, eager steps of "
          f"{n}-sample blocks)")
    return k_ms, p_ms


def phase_timing_mix(device, card: str) -> tuple[float, float]:
    """K5 and its plain version by graph replay at n = N_MIX; returns
    (kernel ms, plain ms)."""
    rng = np.random.default_rng(SEED + 15)
    osc = Osc.create("exact", device=device).set_frequency(MIX_FREQ).set_phase(MIX_PHASE)
    xs = [complex_block(rng, (N_MIX,), device) for _ in range(N_ROT)]  # 64 MB
    kernel = [lambda x=x: mix_down_apply(x, osc.theta, osc.d_theta) for x in xs] * 5
    plain = [lambda x=x: mix_down_reference(x, osc.theta, osc.d_theta) for x in xs] * 5
    p1, k1, k2, p2 = graph_ms(plain), graph_ms(kernel), graph_ms(kernel), graph_ms(plain)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"[timing] {card}: mix_down kernel {k_ms:.4f} ms/block ({k1:.4f}, {k2:.4f}); "
          f"mix_down_reference {p_ms:.4f} ms/block ({p1:.4f}, {p2:.4f}); device time from "
          f"graph replay at n={N_MIX}")
    return k_ms, p_ms


def make_symsync(c: int, device) -> Symsync:
    return Symsync.create_rnyquist(**SYM, batch_shape=(c,), device=device).set_lf_bw(LF_BW)


def sym_same(what: str, got, want) -> bool:
    """Print and return whether (y, valid[, state]) equal bit for bit, with
    the number of channels whose emission mask differs."""
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    masks = int((got[1] != want[1]).flatten(1).any(1).sum())
    err = (got[0] - want[0]).abs().max().item()
    print(f"{what}: bit-identical (values, valid[, state]) {same}; channels whose mask "
          f"differs {masks}; max abs err {err:.3e}; {int(got[1].sum())} emissions")
    return all(same)


def sym_inputs(rng, ss: Symsync, c: int, n: int, device):
    """A random L-sample window and block, xa [c, n + L], and the taps."""
    L = ss.mf.shape[1]
    return complex_block(rng, (c, n + L), device), ss.taps()


def phase_kernel_vs_plain_symsync(device) -> tuple[float, float]:
    """K3 and K4 against their plain versions at C = 5, n = 9 (a partial
    K3 block, a short tile), C = 128, n = 256 and at config[1]'s C = 1024,
    n = 3976, with n_valid < n, bit for bit; returns (K3, K4) max |error| at
    config[1]."""
    rng = np.random.default_rng(SEED + 20)
    n1 = MsResamp.create(MS_RATE, arbitrary_interp="farrow").out_capacity(T1)
    errs = (0.0, 0.0)
    for c, n, n_valid in [(5, 9, 6), (128, 256, None), (C1, n1, n1 - 11)]:
        ss = make_symsync(c, device)
        xa, g = sym_inputs(rng, ss, c, n, device)
        nv = None if n_valid is None else torch.tensor(n_valid, device=device)
        kw = dict(E=2, **ss.kernel_args())
        xs4 = branch_outputs(xa, g)
        k4 = symsync_scan_apply(xs4, nv, **kw), symsync_scan_reference(xs4, nv, **kw)
        del xs4
        k3 = symsync_fused_apply(xa, g, nv, **kw), symsync_fused_reference(xa, g, nv, **kw)
        for name, (got, want) in (("symsync_fused (K3)", k3), ("symsync_scan (K4)", k4)):
            require(tuple(got[0].shape) == (c, n, 2) and bool(torch.isfinite(got[0]).all()),
                    f"{name} output shape and finiteness")
            require(sym_same(f"[kernel-vs-plain] {name} C={c} n={n} n_valid={n_valid}", got,
                             want), f"{name} vs plain at C={c} n={n}")
        errs = tuple((got[0] - want[0]).abs().max().item() for got, want in (k3, k4))
    return errs


def phase_main_path_config1(device) -> tuple[int, int]:
    """Stream N_BLOCKS config[1] blocks through MsResamp → Symsync (K3), then
    N_PALLAS through backend "pallas" (K4); returns (K3 launches, K4
    launches), each from its own run."""
    rng = np.random.default_rng(SEED + 21)
    blocks = [complex_block(rng, (C1, T1), device) for _ in range(N_BLOCKS)]

    def make():
        return (MsResamp.create(MS_RATE, batch_shape=(C1,), arbitrary_interp="farrow",
                                device=device), make_symsync(C1, device))

    ms, ss = make()
    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for x in blocks:
        y, cnt, ms = ms.execute_block(x)
        slots, valid, ss = ss.execute_slots(y, n_valid=cnt)
        outs.append((y, cnt, slots, valid))
    torch.cuda.synchronize()
    counts = read_counts()
    k3 = counts["symsync_fused_apply"]
    print(f"[main-path] MsResamp -> Symsync: {N_BLOCKS} blocks of [{C1}, {T1}] complex64, "
          f"kernel launches {counts}")
    require(k3 == N_BLOCKS and counts["symsync_scan_apply"] == 0,
            f"K3 launches {k3} != blocks {N_BLOCKS}")

    # the plain route: the same resampler (its counts also held against the
    # host-side replay of the u32 schedule), then the XLA-form scan
    ms_p, ss_p = make()
    plain = []
    for i, (x, (y, cnt, slots, _)) in enumerate(zip(blocks, outs)):
        want = ms_p.get_num_output(T1)
        y_p, cnt_p, ms_p = ms_p.execute_block(x)
        require(int(cnt) == int(cnt_p) == want,
                f"block {i}: counts {int(cnt)}, {int(cnt_p)}, host replay {want}")
        require(torch.equal(y, y_p), f"block {i}: resampler output")
        require(tuple(slots.shape) == (C1, y.shape[1], 2), f"block {i}: slot shape")
        require(bool(torch.isfinite(slots).all()), f"block {i}: finite slots")
        if i < N_SYM_CHECK:
            y_s, v_s, ss_p = ss_p.execute_slots(y_p, n_valid=cnt_p, backend="xla")
            plain.append((y_s, v_s))
    require(int(ms.arbitrary.phase) == int(ms_p.arbitrary.phase), "carried u32 phase")
    print(f"[main-path] MsResamp counts equal the plain route and the host replay over "
          f"{N_BLOCKS} blocks ({int(outs[0][1])}..{int(outs[-1][1])} per block), carried phase "
          f"{int(ms.arbitrary.phase)} equal")
    got = [torch.cat([o[j] for o in outs[:N_SYM_CHECK]], 1) for j in (2, 3)]
    want = [torch.cat([p[j] for p in plain], 1) for j in (0, 1)]
    require(sym_same(f"[main-path] Symsync K3 vs the XLA-form scan over {N_SYM_CHECK} blocks",
                     got, want), "K3 route vs XLA-form scan")

    # one resampled block as one Symsync block and as two: bit-identical
    y0, cnt0 = outs[0][0], outs[0][1]
    for backend in ("auto", "pallas"):
        one, _, s1 = make_symsync(C1, device).execute_slots(y0, n_valid=cnt0, backend=backend)
        a, _, s2 = make_symsync(C1, device).execute_slots(y0[:, :SYM_SPLIT], backend=backend)
        b, _, s2 = s2.execute_slots(y0[:, SYM_SPLIT:], n_valid=cnt0 - SYM_SPLIT, backend=backend)
        same = torch.equal(one, torch.cat([a, b], 1)) and torch.equal(s1.tau, s2.tau)
        print(f"[main-path] Symsync {backend}: one block of {y0.shape[1]} (n_valid {int(cnt0)}) "
              f"vs {SYM_SPLIT} + rest: bit-identical {same}")
        require(same, f"Symsync block split ({backend})")

    # K4's route over the first N_PALLAS blocks: the same loop and stream as
    # the XLA-form scan, so bit-identical to it
    ms, ss = make()
    torch.cuda.synchronize()
    reset_counts()
    k4_outs = []
    for x in blocks[:N_PALLAS]:
        y, cnt, ms = ms.execute_block(x)
        slots, valid, ss = ss.execute_slots(y, n_valid=cnt, backend="pallas")
        k4_outs.append((slots, valid))
    torch.cuda.synchronize()
    counts = read_counts()
    k4 = counts["symsync_scan_apply"]
    print(f"[main-path] MsResamp -> Symsync(backend='pallas'): {N_PALLAS} blocks, kernel "
          f"launches {counts}")
    require(k4 == N_PALLAS and counts["symsync_fused_apply"] == 0,
            f"K4 launches {k4} != blocks {N_PALLAS}")
    got = [torch.cat([o[j] for o in k4_outs], 1) for j in (0, 1)]
    want = [torch.cat([p[j] for p in plain[:N_PALLAS]], 1) for j in (0, 1)]
    require(sym_same(f"[main-path] Symsync K4 vs the XLA-form scan over {N_PALLAS} blocks",
                     got, want), "K4 route vs XLA-form scan")
    return k3, k4


def phase_timing_config1(device, card: str) -> dict:
    """K3 and K4 by graph replay, their plain versions by eager calls, and
    the config[1] step; returns {name: (kernel ms, plain ms)}."""
    rng = np.random.default_rng(SEED + 22)
    ms = MsResamp.create(MS_RATE, batch_shape=(C1,), arbitrary_interp="farrow", device=device)
    n1 = ms.out_capacity(T1)
    ss = make_symsync(C1, device)
    kw = dict(E=2, **ss.kernel_args())
    nv = torch.tensor(n1 - 11, device=device)
    sets = [sym_inputs(rng, ss, C1, n1, device) for _ in range(N_ROT)]  # 130 MB of input
    k3 = [lambda a=a: symsync_fused_apply(*a, nv, **kw) for a in sets]
    k3_1, k3_2 = graph_ms(k3, reps=3), graph_ms(k3, reps=3)
    xs4 = [branch_outputs(*sets[i]) for i in range(2)]  # 2.1 GB each
    k4 = [lambda x=x: symsync_scan_apply(x, nv, **kw) for x in xs4]
    k4_1, k4_2 = graph_ms(k4, reps=3), graph_ms(k4, reps=3)
    p3 = cuda_ms(lambda: symsync_fused_reference(*sets[0], nv, **kw), iters=2, warmup=1)
    p4 = cuda_ms(lambda: symsync_scan_reference(xs4[0], nv, **kw), iters=2, warmup=1)
    del xs4
    print(f"[timing] {card}: symsync_fused (K3) {(k3_1 + k3_2) / 2:.4f} ms/block ({k3_1:.4f}, "
          f"{k3_2:.4f}), graph replay; symsync_fused_reference {p3:.2f} ms/block, eager "
          f"(2 calls after one); at C={C1}, n={n1}, n_valid={n1 - 11}")
    print(f"[timing] {card}: symsync_scan (K4) {(k4_1 + k4_2) / 2:.4f} ms/block ({k4_1:.4f}, "
          f"{k4_2:.4f}), graph replay; symsync_scan_reference {p4:.2f} ms/block, eager "
          f"(2 calls after one)")

    blocks = [complex_block(rng, (C1, T1), device) for _ in range(N_ROT)]

    def step_msps(iters: int, warmup: int, backend: str) -> float:
        state = [ms, ss, 0]

        def step():
            y, cnt, state[0] = state[0].execute_block(blocks[state[2] % N_ROT])
            _, _, state[1] = state[1].execute_slots(y, n_valid=cnt, backend=backend)
            state[2] += 1

        return C1 * T1 / (cuda_ms(step, iters, warmup) * 1e-3) / 1e6

    f_msps = step_msps(20, 3, "auto")
    p_msps = step_msps(2, 1, "xla")
    print(f"[timing] {card}: config[1] step MsResamp -> Symsync {f_msps:.1f} Msps (K3, 20 eager "
          f"steps), {p_msps:.2f} Msps (XLA-form scan, 2 eager steps) (input complex "
          f"Msamples/s, [{C1}, {T1}] blocks)")
    return {"symsync_fused": ((k3_1 + k3_2) / 2, p3), "symsync_scan": ((k4_1 + k4_2) / 2, p4)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch sees none")
    # plain oracles (matmuls, convolutions) in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    name, smi = phase_device()
    phase_build()
    errs = {
        "chain_fp32": phase_kernel_vs_plain(device),
        "channelizer_fp32": phase_kernel_vs_plain_channelizer(device),
        "mix_down": phase_kernel_vs_plain_mix(device),
    }
    errs["symsync_fused"], errs["symsync_scan"] = phase_kernel_vs_plain_symsync(device)
    launches = {
        "chain_fp32": phase_main_path(device),
        "channelizer_fp32": phase_main_path_config4(device),
        "mix_down": phase_mix_path(device),
    }
    launches["symsync_fused"], launches["symsync_scan"] = phase_main_path_config1(device)
    times = {
        "chain_fp32": phase_timing(device, smi),
        "channelizer_fp32": phase_timing_config4(device, smi),
        "mix_down": phase_timing_mix(device, smi),
        **phase_timing_config1(device, smi),
    }
    sources = {
        "chain_fp32": ("yagi_tpu_torch/csrc/chain.cu", "yagi_tpu/kernels/chain.py:87"),
        "channelizer_fp32": ("yagi_tpu_torch/csrc/channelizer.cu",
                             "yagi_tpu/kernels/channelizer.py:71"),
        "mix_down": ("yagi_tpu_torch/csrc/mix.cu", "yagi_tpu/kernels/mix.py:29"),
        "symsync_fused": ("yagi_tpu_torch/csrc/symscan.cu", "yagi_tpu/kernels/symscan.py:201"),
        "symsync_scan": ("yagi_tpu_torch/csrc/symscan.cu", "yagi_tpu/kernels/symscan.py:72"),
    }
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": launches[k],
        "max_abs_err": errs[k],
        "ms": times[k][0],
        "plain_ms": times[k][1],
    } for k, (src, replaces) in sources.items()]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
