"""Build and bind the port's CUDA kernels: nvcc into a shared library, ctypes.

The sources ``yagi_tpu_torch/csrc/*.cu`` (and the headers ``*.cuh`` they
include) have a plain C interface and do not include PyTorch's headers, so
nvcc compiles them in seconds. Each ``*.cu`` compiles in its own nvcc
process, all started together, and the objects link into one library. It goes
to ``build/yagi_tpu_torch/`` beside the package, named by a hash of the
sources, the headers and the flags, and is built at first use. Pointers and
the stream are passed as ``c_void_p`` (a bare Python int would be cut to 32
bits). :func:`launch` makes every wrapper's call into the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from .. import trace

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "yagi_tpu_torch"
# no --use_fast_math: it swaps sincosf for __sinf/__cosf (see csrc/nco.cuh)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: argument types, in the order of their declarations in csrc/
_SIGNATURES = {
    # xr, xi, gc, hist_r, hist_i, theta0, dtheta, yr, yi, C, T, P, Kp, stream
    "yagi_chain_planar": [_P] * 9 + [_I] * 4 + [_P],
    # x, gc, hist_r, hist_i, theta0, dtheta, y, C, T, P, Kp, stream
    "yagi_chain_c64": [_P] * 7 + [_I] * 4 + [_P],
    # xr, xi, taps, hr, hi, hist_r, hist_i, yr, yi, T, p, nh, stream
    "yagi_channelizer_fp32": [_P] * 9 + [_I] * 3 + [_P],
    # xr, xi, taps, hr, hist_r, hist_i, rp_in, yr, yi, fm, rp_out, hist_r_out,
    # hist_i_out, T, p, nh, ref, stream
    "yagi_channelizer_fm": [_P] * 13 + [_I] * 3 + [_F, _P],
    # x, theta0, dtheta, y, n, stream
    "yagi_mix_down": [_P] * 4 + [_I, _P],
    # xs4, n_valid, st_in, locked, radj, pll_a, pll_b, y, valid, st_out,
    # deferred, C, n, P, E, k_out, 1/k, stream
    "yagi_symsync_scan": [_P] * 11 + [_I] * 5 + [_F, _P],
    # the same, then chans, w (K4's staged layout)
    "yagi_symsync_scan_staged": [_P] * 11 + [_I] * 5 + [_F, _I, _I, _P],
    # xa, g, n_valid, st_in, locked, radj, pll_a, pll_b, y, valid, st_out,
    # deferred, C, n, L, P, E, k_out, 1/k, stream
    "yagi_symsync_fused": [_P] * 12 + [_I] * 6 + [_F, _P],
    # x, g, y2p, alpha, scale, thr, locked, mode, timer, y, g_out, y2p_out,
    # mode_out, timer_out, C, n, timeout, stream
    "yagi_agc_scan": [_P] * 14 + [_I] * 3 + [_P],
    # y, valid, table, mu, alpha, beta, the 10 state arrays, syms, soft,
    # mask, the 10 new state arrays, C, S, M, h_len, k_eq, the device int64
    # the kernel adds its rounds to, stream
    "yagi_qam_eq_scan_counted": [_P] * 29 + [_I] * 5 + [_P, _P],
    # x, b, a, scale, v_in, y, v_out, scratch, C, T, m, sos, cx, cc, inst, stream
    "yagi_iir_scan": [_P] * 8 + [_I] * 7 + [_P],
    # x, b, a, scale, v_in, y, v_out, C, T, m, nst, cx, cc, inst, stream
    "yagi_iir_chunked": [_P] * 7 + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def source_digest(csrc: Path = _CSRC) -> str:
    """Hash of the flags and of every ``*.cu`` and ``*.cuh`` under ``csrc``:
    an edit to a header alone gives a new library name."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build(csrc: Path = _CSRC) -> tuple[Path, str]:
    """Compile the kernels of ``csrc`` (the package's own by default; another
    directory builds a variant for an A/B; its sources may include the
    package's headers) unless a library for these sources and flags exists.

    Returns the library's path and the compilers' output (with ptxas's
    register and spill report), or ``""`` when the library was already built.
    """
    csrc = Path(csrc)
    tag = source_digest(csrc)
    out = BUILD_DIR / f"libyagi_tpu_torch_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace.count("library.builds")
    pid = os.getpid()
    nvcc = _nvcc()
    sources = sorted(csrc.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}_{tag}.{pid}.o" for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(sources, procs):  # wait for every compiler before raising
        log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{log}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_name(f"{out.name}.{pid}.tmp")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(logs) + link.stdout + link.stderr


def bind(path: Path, signatures: dict = _SIGNATURES) -> ctypes.CDLL:
    """Load a kernel library and set the C signatures of the entry points it
    has (a variant built from part of the sources has only some)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C signatures."""
    with trace.span("yagi.library", always=True):
        return bind(build()[0])


def launch(kernel, device, entry: str, *args) -> None:
    """Call the library's C entry point ``entry`` with ``args`` and the
    current stream of ``device``, inside the span of ``kernel``'s launch
    (``kernel`` is the registered wrapper it is for, which counts it); raise
    on a CUDA error."""
    lib = library()
    with trace.span(kernel.launch_span):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error {rc}")
