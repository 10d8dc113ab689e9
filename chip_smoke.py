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
  (mix_down_apply, kernel K5, csrc/mix.cu).

Five phases:

1. device: the card's name and power limit;
2. build: the CUDA kernels, compiled with nvcc from this checkout;
3. kernel vs plain: each kernel against its plain torch version on the same
   CUDA tensors, at a small shape and at its path's shape;
4. main paths: each streams 16 blocks with its state carried, each block
   held against the plain oracle (RxChain, Firpfbch → Freqdem,
   Osc.mix_block_down); every launch count is set to 0 just before a path
   and read just after it; block-split invariance;
5. timing with CUDA events: each kernel and its plain version by CUDA-graph
   replay, and the config[0] and config[4] steps.

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
from yagi_tpu_torch.kernels.mix import mix_down_apply, mix_down_reference  # noqa: E402
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

KERNELS = (fused_chain_apply, fused_channelizer_apply, mix_down_apply)


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
        if "registers" in line or "spill" in line:
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
    launches = {
        "chain_fp32": phase_main_path(device),
        "channelizer_fp32": phase_main_path_config4(device),
        "mix_down": phase_mix_path(device),
    }
    times = {
        "chain_fp32": phase_timing(device, smi),
        "channelizer_fp32": phase_timing_config4(device, smi),
        "mix_down": phase_timing_mix(device, smi),
    }
    sources = {
        "chain_fp32": ("yagi_tpu_torch/csrc/chain.cu", "yagi_tpu/kernels/chain.py:87"),
        "channelizer_fp32": ("yagi_tpu_torch/csrc/channelizer.cu",
                             "yagi_tpu/kernels/channelizer.py:71"),
        "mix_down": ("yagi_tpu_torch/csrc/mix.cu", "yagi_tpu/kernels/mix.py:29"),
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
