"""The streaming FIR filter's block: ``fir_block_apply`` (every
``FirFilter.execute_block`` on the card; BASELINE config[2]'s four 129-tap
filters).

yagi_tpu filters a block with the banded matmul of
``yagi_tpu/filter/_conv.py`` (plain XLA, no ``pallas_call``): the stream
cut into rows of 128 outputs, each row's window written out as a frame,
times a banded tap matrix. In eager torch that writes 403 MB of frames a
config[2] step and reads them back, and half the gemms' multiply-adds are
the band's zeros; on the card it is one hand-written direct-form kernel,
``csrc/fir.cu``, beside its plain version :func:`fir_block_reference`, that
banded matmul. It computes

    y[..., m] = scale · Σ_k h[k] · xa[..., m + L − 1 − k],   0 ≤ m < n,

with xa = (window[..., 1:], x), the carried window's L − 1 newest samples
before the block: x [..., n] of any batch shape and n ≥ 0, window [..., L],
taps h [L] (L ≥ 1), ``scale`` a 0-d tensor of h's type; y [..., n] of
``promote_types(x, h)``. The kernel takes float32 or complex64 signals and
taps, each pair at the real multiply-adds its types need (:func:`real_macs`),
and sums every output's taps in one fixed order (j = 0 … L − 1 over the
flipped taps, fmaf), so a block cut anywhere gives the bits of the whole.
The plain version sums in cuBLAS's order: the two agree within float32
rounding, not bit for bit.

CPU tensors run the plain version; CUDA tensors launch the kernel (counted
in ``fir_block_apply.launches``) or raise: another dtype, a tap count whose
staged tile passes a block's shared memory (:func:`smem_bytes`). Either
route counts the multiply-adds of ``trace.py``'s ``conv.*`` counters: the
plain version through the banded matmul (its frames, its gemms' multiply-adds
and its taps'), the kernel ``conv.frame_bytes`` += 0 and ``conv.macs`` =
``conv.tap_macs`` += B·n·L·r, r the real multiply-adds a tap.
"""

from __future__ import annotations

import math

import torch

from .. import trace
from ._check import check_tensors, route

__all__ = ["fir_block_apply", "fir_block_reference", "real_macs", "smem_bytes"]

# csrc/fir.cu's layout, mirrored: change them together
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100
THREADS, R = 128, 12  # threads a block, outputs a thread
TILE = THREADS * R  # outputs a block
DTYPES = (torch.float32, torch.complex64)  # the kernel's signal and tap types


def _round4(v: int) -> int:
    return (v + 3) & ~3


def smem_bytes(L: int, x_complex: bool, h_complex: bool) -> int:
    """Dynamic shared memory of a kernel block at L taps: two staged tiles
    of a plane each (two where the signal is complex), the outputs' plane
    (two where they are complex), the flipped taps' plane (two where they
    are complex)."""
    span, lg = _round4(TILE + L + R), _round4(L + 2 * R)
    planes_in, planes_out = (2 if x_complex else 1), (2 if x_complex or h_complex else 1)
    return (2 * planes_in * span + planes_out * TILE + (2 if h_complex else 1) * lg) * 4


def real_macs(x_dtype, h_dtype) -> int:
    """Real multiply-adds a tap costs an output: 1 (real × real), 2 (one
    side complex) or 4 (complex × complex)."""
    return (2 if x_dtype.is_complex else 1) * (2 if h_dtype.is_complex else 1)


def fir_block_reference(x, window, h, scale):
    """``fir_block_apply``'s plain version: the banded matmul of
    ``filter/_conv.py`` over xa = (window[..., 1:], x), then the scale
    (counted in ``conv.*``)."""
    from ..filter._conv import causal_conv_valid  # filter/ imports this module

    xa = torch.cat([window[..., 1:].to(x.dtype), x], dim=-1)
    return causal_conv_valid(xa, h) * scale


def _check(x, window, h, scale) -> None:
    """Shapes and devices both routes need; contiguity and the card's dtypes
    are the kernel route's own checks."""
    fn = "fir_block_apply"
    if not isinstance(x, torch.Tensor) or x.dim() < 1:
        raise ValueError(f"{fn}: x must be a tensor [..., n]")
    if not isinstance(h, torch.Tensor) or h.dim() != 1 or h.shape[0] < 1:
        raise ValueError(f"{fn}: h must be a [L] tensor with L >= 1")
    shapes = {"window": (window, x.shape[:-1] + h.shape), "scale": (scale, ())}
    for name, (t, shape) in shapes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: {name} must be a tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    for name, t in (("window", window), ("h", h), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on {x.device}")


@trace.kernel
def fir_block_apply(x, window, h, scale):
    """A FIR filter's block: ``x`` [..., n] after the carried ``window``
    [..., L] through the taps ``h`` [L] (h[0] on the newest sample), times
    the 0-d ``scale``; returns y [..., n] as the module docstring says.

    CPU tensors run :func:`fir_block_reference`; CUDA tensors launch
    ``csrc/fir.cu`` on float32 or complex64 signals and taps (the window is
    taken in x's type, the scale must be in h's), or raise.
    """
    _check(x, window, h, scale)
    if route(x.device, "fir_block_apply") == "reference":
        return fir_block_reference(x, window, h, scale)

    from ._build import launch

    fn = "fir_block_apply"
    if x.dtype not in DTYPES or h.dtype not in DTYPES:
        raise TypeError(f"{fn}: the kernel takes float32 or complex64 signals and taps, got "
                        f"{x.dtype} through {h.dtype}")
    batch, n, L = x.shape[:-1], x.shape[-1], h.shape[0]
    C = math.prod(batch)
    x, h = x.contiguous(), h.contiguous()
    window = window.to(x.dtype).contiguous()
    check_tensors(fn, x.device, {"scale": (scale, (), h.dtype)})
    nbytes = smem_bytes(L, x.is_complex(), h.is_complex())
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{fn}: {L} taps stage {nbytes} bytes a block, past the card's "
                         f"{SMEM_LIMIT}")
    if C >= 1 << 31 or C * -(-n // TILE) >= 1 << 31 or n + L + TILE >= 1 << 31:
        raise ValueError(f"{fn}: [{C}, {n}] through {L} taps is past the kernel's index range")
    y = torch.empty(batch + (n,), dtype=torch.promote_types(x.dtype, h.dtype), device=x.device)
    macs = C * n * L * real_macs(x.dtype, h.dtype)
    trace.count("conv.frame_bytes", 0)
    trace.count("conv.macs", macs)
    trace.count("conv.tap_macs", macs)
    if C == 0 or n == 0:
        return y
    launch(fir_block_apply, x.device, "yagi_fir_block",
           x.data_ptr(), window.data_ptr(), h.data_ptr(), scale.data_ptr(), y.data_ptr(),
           C, n, L, int(x.is_complex()), int(h.is_complex()))
    fir_block_apply.launches += 1
    return y
