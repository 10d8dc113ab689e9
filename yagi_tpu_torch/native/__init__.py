"""ctypes bindings for the native C++ layer (``native/*.cpp``).

Port of :mod:`yagi_tpu.native`. The same C ABI (liquid's ``bsequence_*``
and the IQ capture reader ``iql_*``) is compiled from the same sources,
``native/bsequence.cpp`` and ``native/iq_loader.cpp``, with ``native/Makefile``'s
flags, into ``build/yagi_tpu_torch/`` beside the package: the library is
named by a hash of the sources and flags, built with g++ at first use, and
the committed ``native/libyagi_native.so`` is never loaded or written. A
build goes to a file named by the process id and is moved into place, so
two processes building at once never see a partial library.

:class:`IqStreamLoader` hands out planar float32 blocks as tensors on a
device: on the card it fills a ring of page-locked host buffers and copies
each to the card on the current stream without blocking the host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from .._src.device import resolve_device
from ..errors import ConfigError, InternalError
from ..kernels._build import BUILD_DIR

__all__ = ["load_native", "NativeBSequence", "native_available", "IqStreamLoader"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
SOURCES = (_NATIVE_DIR / "bsequence.cpp", _NATIVE_DIR / "iq_loader.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lpthread",)

_P = ctypes.c_void_p
_SIGNATURES = {  # name: (argument types, result type)
    "bsequence_create": ([ctypes.c_uint], _P),
    "bsequence_destroy": ([_P], None),
    "bsequence_reset": ([_P], None),
    "bsequence_push": ([_P, ctypes.c_uint], None),
    "bsequence_init": ([_P, ctypes.c_char_p], None),
    "bsequence_circshift": ([_P], None),
    "bsequence_correlate": ([_P, _P], ctypes.c_int),
    "bsequence_add": ([_P] * 3, None),
    "bsequence_mul": ([_P] * 3, None),
    "bsequence_accumulate": ([_P], ctypes.c_uint),
    "bsequence_get_length": ([_P], ctypes.c_uint),
    "bsequence_index": ([_P, ctypes.c_uint], ctypes.c_uint),
    "bsequence_create_ccodes": ([_P, _P], ctypes.c_int),
    "iql_open": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_int], _P),
    "iql_next": ([_P, _P, _P], ctypes.c_long),
    "iql_total_read": ([_P], ctypes.c_long),
    "iql_close": ([_P], None),
}


def library_path(out_dir: Path = BUILD_DIR) -> Path:
    """Where the library for these sources and flags lives under ``out_dir``."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return Path(out_dir) / f"libyagi_native_{digest.hexdigest()[:16]}.so"


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/*.cpp`` with g++ into ``out_dir`` unless the library
    for these sources and flags is there; returns its path. Raises
    :class:`InternalError` with g++'s output when the build fails."""
    out = library_path(out_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise InternalError(f"native library build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise InternalError(f"native library build failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.cache
def load_native() -> ctypes.CDLL:
    """The native library, built if needed, with its C signatures. Raises
    :class:`InternalError` where it cannot be built (yagi_tpu returns None)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here (tests skip on
    False, as yagi_tpu's do)."""
    try:
        load_native()
    except InternalError:
        return False
    return True


class NativeBSequence:
    """Python handle over the C ABI (mirrors liquid's bsequence object)."""

    def __init__(self, num_bits: int):
        self._lib = load_native()
        self._q = self._lib.bsequence_create(num_bits)
        if not self._q:
            raise ConfigError("invalid bsequence length")

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.bsequence_destroy(self._q)
            self._q = None

    def push(self, bit: int) -> None:
        self._lib.bsequence_push(self._q, bit)

    def init(self, data: bytes) -> None:
        self._lib.bsequence_init(self._q, data)

    def circshift(self) -> None:
        self._lib.bsequence_circshift(self._q)

    def correlate(self, other: "NativeBSequence") -> int:
        return self._lib.bsequence_correlate(self._q, other._q)

    def accumulate(self) -> int:
        return self._lib.bsequence_accumulate(self._q)

    def get_length(self) -> int:
        return self._lib.bsequence_get_length(self._q)

    def index(self, i: int) -> int:
        return self._lib.bsequence_index(self._q, i)

    def add(self, other: "NativeBSequence") -> "NativeBSequence":
        out = NativeBSequence(self.get_length())
        self._lib.bsequence_add(self._q, other._q, out._q)
        return out

    def mul(self, other: "NativeBSequence") -> "NativeBSequence":
        out = NativeBSequence(self.get_length())
        self._lib.bsequence_mul(self._q, other._q, out._q)
        return out

    @classmethod
    def create_ccodes(cls, num_bits: int):
        a = cls(num_bits)
        b = cls(num_bits)
        if a._lib.bsequence_create_ccodes(a._q, b._q) != 0:
            raise ConfigError("invalid ccode length")
        return a, b


class IqStreamLoader:
    """Native double-buffered IQ capture reader (native/iq_loader.cpp).

    A background C++ thread reads interleaved IQ from disk and deinterleaves
    it into planar float32 blocks, so Python blocks only when the disk cannot
    keep up. Formats: "cf32", "ci16" (÷32768), "cu8" (offset-128, ÷128).
    Each block is a planar ``(re, im)`` pair of float32 tensors of at most
    ``block_samples`` on ``device`` (``resolve_device``: the card unless the
    caller asks for the CPU), ``(None, None)`` at EOF. On the card the reader
    fills one of ``n_buffers`` page-locked host pairs and copies it to the
    card on the current stream without blocking; a pair is refilled only
    after the event recorded behind its last copy has passed. On the CPU each
    block is a fresh pair of tensors.

    >>> with IqStreamLoader(path, "ci16", block_samples=1 << 21) as src:
    ...     for re, im in src:
    ...         yr, yi, chz = chz.analyzer_execute_planar(re, im)
    """

    _FORMATS = {"cf32": 0, "ci16": 1, "cu8": 2}

    def __init__(self, path, fmt: str = "cf32", block_samples: int = 1 << 17,
                 n_buffers: int = 4, device=None):
        self.device = resolve_device(device)
        if fmt not in self._FORMATS:
            raise ConfigError(f"unknown IQ format {fmt!r}")
        self.block_samples = int(block_samples)
        self._lib = load_native()
        self._h = self._lib.iql_open(str(path).encode(), self._FORMATS[fmt],
                                     self.block_samples, int(n_buffers))
        if not self._h:
            raise OSError(f"cannot open IQ stream {str(path)!r}")
        self._ring, self._slot = [], 0
        if self.device.type == "cuda":
            self._ring = [
                (torch.empty(self.block_samples, dtype=torch.float32, pin_memory=True),
                 torch.empty(self.block_samples, dtype=torch.float32, pin_memory=True),
                 torch.cuda.Event())
                for _ in range(int(n_buffers))
            ]

    def next_block(self):
        """(re, im) float32 tensors of ≤ block_samples on the loader's
        device; (None, None) at EOF."""
        if self._ring:
            re, im, copied = self._ring[self._slot]
            copied.synchronize()  # this pair's last copy to the card has ended
        else:
            re = torch.empty(self.block_samples, dtype=torch.float32)
            im = torch.empty(self.block_samples, dtype=torch.float32)
        n = self._lib.iql_next(self._h, re.data_ptr(), im.data_ptr())
        if n <= 0:
            return None, None
        if not self._ring:
            return re[:n], im[:n]
        out = (re[:n].to(self.device, non_blocking=True),
               im[:n].to(self.device, non_blocking=True))
        copied.record()
        self._slot = (self._slot + 1) % len(self._ring)
        return out

    def total_read(self) -> int:
        return self._lib.iql_total_read(self._h)

    def __iter__(self):
        while True:
            re, im = self.next_block()
            if re is None:
                return
            yield re, im

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.iql_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
