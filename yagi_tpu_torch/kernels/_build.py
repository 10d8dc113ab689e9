"""Build and bind the port's CUDA kernels: nvcc into a shared library, ctypes.

The sources ``yagi_tpu_torch/csrc/*.cu`` have a plain C interface and do not
include PyTorch's headers, so nvcc compiles them in seconds. The library goes
to ``build/yagi_tpu_torch/`` beside the package, named by a hash of the
sources and flags, and is built at first use. Pointers and the stream are
passed as ``c_void_p`` (a bare Python int would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "yagi_tpu_torch"
# no --use_fast_math: it swaps sincosf for __sinf/__cosf (see csrc/chain.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library for these sources exists.

    Returns the library's path and the compiler's output (with ptxas's
    register and spill report), or ``""`` when the library was already built.
    """
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libyagi_tpu_torch_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.yagi_chain_fp32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
