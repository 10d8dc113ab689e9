#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

BASELINE config[0] (64-tap Kaiser FIR → 2× polyphase interpolator → u32 NCO
mix-down, 16 channels, blocks of 2^17 complex samples) through the port,
yagi_tpu_torch, in five phases:

1. device: the card's name and power limit;
2. build: the CUDA kernels, compiled with nvcc from this checkout;
3. kernel vs plain: each kernel against its plain torch version on the same
   CUDA tensors, at a small shape and at the config[0] shape;
4. main path: FusedRxChain streams 16 blocks, each held against the plain
   RxChain, with the kernel launches counted; block-split invariance;
5. timing with CUDA events: the kernel, its plain version, and both chains.

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

from yagi_tpu_torch.chains import FusedRxChain, RxChain  # noqa: E402
from yagi_tpu_torch.kernels import _build  # noqa: E402
from yagi_tpu_torch.kernels.chain import (  # noqa: E402
    fused_chain_apply,
    fused_chain_reference,
)

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


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs() / (a.abs() + 1e-3)).max().item()


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
    fused_chain_apply.launches = 0
    outs = []
    for x in blocks:
        y, k, fused = fused.step(x)
        outs.append((y, k))
    torch.cuda.synchronize()
    launches = fused_chain_apply.launches
    print(f"[main-path] FusedRxChain: {N_BLOCKS} steps of [{C}, {T}] complex64, "
          f"kernel launches {launches}")
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch sees none")
    # plain oracles (matmuls, convolutions) in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    name, smi = phase_device()
    phase_build()
    max_abs = phase_kernel_vs_plain(device)
    launches = phase_main_path(device)
    k_ms, p_ms = phase_timing(device, smi)

    print(json.dumps({"kernels": [{
        "name": "chain_fp32",
        "route": "cuda",
        "source": "yagi_tpu_torch/csrc/chain.cu",
        "replaces": "yagi_tpu/kernels/chain.py:87",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
