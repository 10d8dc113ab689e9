"""The IIR recurrences over a block (BASELINE config[2]'s de-emphasis, and
every ``IirFilter``, ``IirFilterSos`` and IIR Hilbert / resampling filter).

yagi_tpu runs them through XLA with no Pallas kernel, in two ways: the
sequential per-sample scan (``planar_scan``, ``yagi_tpu/filter/iirfilt.py:317``
and ``iirfiltsos.py:98``) and, for ``parallelize()``d filters, the log-depth
``associative_scan`` (``yagi_tpu/filter/_linrec.py:76,89``). In eager torch
the first is several launches per sample and the second ~log₂ T passes over
the block, so the port runs both as one hand-written CUDA source,
``csrc/iir.cu`` (its recurrence body in ``csrc/iir.cuh``), each launch form
beside its plain version:

* ``iir_scan`` — the sequential recurrence, one thread per channel, in the
  order of ``iirfilt.py:295-315``. TF form (``sos=False``): per sample
  s = a₁·v₁ + … + a_m·v_m (left to right), v₀ = x − s, y = b₀·v₀ + (b₁·v₁ +
  … + b_m·v_m), the state shifted (newest first). SOS form (``sos=True``):
  the sections chained inside a sample, v₀ = (y − a₁·v₁) − a₂·v₂, then y =
  (b₀·v₀ + b₁·v₁) + b₂·v₂. Every product and sum is rounded on its own, a
  complex product is written out as (cr·vr − ci·vi, cr·vi + ci·vr), and the
  output is multiplied by the scale after the recurrence: the kernel equals
  :func:`iir_scan_reference` bit for bit.
* ``iir_chunked`` — the same filter cut into chunks along time (one thread
  a chunk): each chunk runs the all-pole recurrence from a zero state, the
  chunk end states are carried along the channel by a doubling scan with
  the companion matrix's chunk powers (``_linrec.py``'s composition; inside
  a warp by shuffles, then across the warps' end states), and each chunk
  reruns the whole DF-II step from its true entering state.
  The same recurrence in another summation order: held by tolerance to its
  plain version :func:`iir_chunked_reference` (``allpole_parallel`` and the
  numerator over the ``ext`` sequence, ``iirfilt.py:233-266``), the form of
  yagi_tpu's parallel route. SOS filters run their sections one after
  another inside the launch.

Layout, channel-major: ``x`` [C, T] float32 or complex64 (the signal type);
``b``, ``a`` the normalized coefficients, TF [n] (float32, or complex64 with
a complex signal) or SOS [nsos, 3] float32; ``scale`` a 0-d tensor of the
coefficients' type; ``v`` the state of the signal type, TF [C, n − 1] or SOS
[C, nsos, 2], newest first. Both return ``(y, v_new)``, ``y`` [C, T] of the
signal type, the state in a fresh array.

The instances and shape gates are decided here, in Python, before a
launch, mirroring the ``.cu`` (:func:`scan_instance`,
:func:`chunked_instance`, :func:`chunked_fits`): ``iir_scan`` runs a TF
filter of order 0, 1 or 2 and an SOS filter of 1 to 4 sections in an
instance specialised to that order, other states of up to ``SCAN_REG``
values in a generic register instance, a longer one in a ring in shared
memory, or in device memory where shared memory cannot hold it;
``iir_chunked`` runs stages of order 1 and 2 in specialised instances and
orders 0 and 3 to ``CHUNK_MAX_M`` in a generic one, and otherwise hands the
block to the sequential kernel (another summation order of the same
function).
"""

from __future__ import annotations

import torch

from .. import trace
from ._check import check_tensors, route

__all__ = [
    "iir_scan_apply",
    "iir_scan_reference",
    "iir_chunked_apply",
    "iir_chunked_reference",
    "scan_instance",
    "chunked_instance",
    "chunked_fits",
    "chunked_smem_bytes",
]

# csrc/iir.cu's constants, mirrored: change them together
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100
SCAN_CHANS = 8  # iir_scan: loop threads (channels) a block
SCAN_TILE = 256  # iir_scan: samples a slab
SCAN_REG = 8  # iir_scan: state values (TF m, SOS 2·nsos) held in registers
# iir_scan's instances, as csrc/iir.cu numbers them: the generic register
# instance (TF order ≤ SCAN_REG), the two rings, then the specialised ones
SCAN_INSTANCES = {"register": 0, "shared": 1, "global": 2, "tf0": 3, "tf1": 4, "tf2": 5,
                  "sos1": 6, "sos2": 7, "sos3": 8, "sos4": 9}
CHUNK_THREADS = 128  # iir_chunked: chunks a segment, one thread each
CHUNK_LEN = 32  # iir_chunked: samples a chunk
CHUNK_WARP_LOG = 2  # log2(CHUNK_THREADS / 32): the scan's steps across warps
CHUNK_MAX_M = 8  # iir_chunked: the largest order of a stage
# iir_chunked's chunk powers M^(CHUNK_LEN·k): k = 1 … 32, then 64, 128, …
CHUNK_POWERS = 32 + CHUNK_WARP_LOG - 1
CHUNK_INSTANCES = {"generic": 0, "order1": 1, "order2": 2}


def _elem(cx: bool) -> int:
    return 8 if cx else 4


def scan_instance(state_len: int, cx: bool, sos: bool = False) -> tuple[str, int]:
    """``iir_scan``'s instance for a state of ``state_len`` values (TF m, SOS
    2·nsos) of a real or complex signal, and its dynamic shared memory in
    bytes (``csrc/iir.cu::scan_smem_bytes``): ``"tf0"``, ``"tf1"``,
    ``"tf2"`` (TF of that order) or ``"sos1"`` … ``"sos4"`` (SOS of that
    many sections), the state in registers and the order fixed at compile
    time; ``"register"`` (a TF state of up to ``SCAN_REG`` values, the order
    read at run time); ``"shared"`` (a ring of the state in shared memory)
    or ``"global"`` (the ring in device memory)."""
    e = _elem(cx)
    slabs = 4 * SCAN_CHANS * (SCAN_TILE * e + 16)  # two slabs of x rows, two of y rows
    if state_len <= SCAN_REG:
        if sos:
            return f"sos{state_len // 2}", slabs
        return (f"tf{state_len}" if state_len <= 2 else "register"), slabs
    ring = SCAN_CHANS * state_len * e
    if slabs + ring <= SMEM_LIMIT:
        return "shared", slabs + ring
    return "global", slabs


def chunked_instance(m: int) -> str:
    """``iir_chunked``'s instance for stages of order ``m``: ``"order1"`` and
    ``"order2"`` have the order fixed at compile time (config[2]'s
    de-emphasis; every SOS stage), ``"generic"`` reads it at run time."""
    return {1: "order1", 2: "order2"}.get(m, "generic")


def chunked_smem_bytes(m: int, nst: int, cx: bool, cc: bool) -> int:
    """``iir_chunked``'s dynamic shared memory for ``nst`` stages of order
    ``m``, as ``csrc/iir.cu::chunked_smem_bytes`` computes it: two segment
    buffers, the chunk powers' float64 (or complex128) working copies,
    coefficients, carried states and the warps' end states (float2 each),
    and the chunk powers (float, or float2 for complex coefficients)."""
    e = _elem(cx)
    segs = 2 * CHUNK_THREADS * CHUNK_LEN * e
    work = nst * (CHUNK_POWERS + 2) * m * m * (16 if cc else 8)
    coefs = 2 * nst * (m + 1) * 8
    carry = nst * max(m, 1) * 8
    tot = (CHUNK_THREADS // 32) * max(m, 1) * 8
    q = nst * CHUNK_POWERS * m * m * (8 if cc else 4)
    return segs + work + coefs + carry + tot + q


def chunked_fits(m: int, nst: int, cx: bool, cc: bool) -> bool:
    """Whether ``iir_chunked``'s kernel takes ``nst`` stages of order ``m``."""
    return m <= CHUNK_MAX_M and chunked_smem_bytes(m, nst, cx, cc) <= SMEM_LIMIT


# ------------------------------------------------------------ plain versions
def _planes(t):
    return (t.real, t.imag) if t.is_complex() else (t, None)


def _mul(c, v):
    """c·v on planes (each part None when real): the complex product written
    out, (cr·vr − ci·vi, cr·vi + ci·vr), every op rounded on its own."""
    cr, ci = c
    vr, vi = v
    if ci is not None:
        return cr * vr - ci * vi, cr * vi + ci * vr
    return cr * vr, None if vi is None else cr * vi


def _add(p, q):
    return p[0] + q[0], None if p[1] is None else p[1] + q[1]


def _sub(p, q):
    return p[0] - q[0], None if p[1] is None else p[1] - q[1]


def _join(p):
    return p[0] if p[1] is None else torch.complex(p[0], p[1])


def _check(fn: str, x, b, a, scale, v, sos: bool) -> tuple[int, int, int]:
    """Validate the arguments; return (C, T, m) with m the TF order or the
    number of sections."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{fn}: x must be a [C, T] tensor")
    C, T = x.shape
    if x.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"{fn}: x must be float32 or complex64, got {x.dtype}")
    cdt = b.dtype
    if cdt not in (torch.float32, torch.complex64) or (cdt.is_complex and not x.is_complex()):
        raise TypeError(f"{fn}: coefficients {cdt} do not go with a {x.dtype} signal")
    if sos:
        nsos = b.shape[0] if b.dim() == 2 else -1
        if cdt != torch.float32:
            raise TypeError(f"{fn}: SOS coefficients must be float32")
        check_tensors(fn, x.device, {"x": (x, (C, T), x.dtype), "b": (b, (nsos, 3), cdt),
                                     "a": (a, (nsos, 3), cdt), "scale": (scale, (), cdt),
                                     "v": (v, (C, nsos, 2), x.dtype)})
        if nsos < 1:
            raise ValueError(f"{fn}: an SOS filter needs at least one section")
        return C, T, nsos
    n = b.shape[0] if b.dim() == 1 else 0
    check_tensors(fn, x.device, {"x": (x, (C, T), x.dtype), "b": (b, (n,), cdt),
                                 "a": (a, (n,), cdt), "scale": (scale, (), cdt),
                                 "v": (v, (C, n - 1), x.dtype)})
    if n < 1:
        raise ValueError(f"{fn}: a TF filter needs at least one coefficient")
    return C, T, n - 1


def iir_scan_reference(x, b, a, scale, v, *, sos: bool):
    """``iir_scan``'s plain version: the recurrence as torch ops over the
    time axis, one [C] vector per state value, in the kernel's order (module
    docstring). Same arguments and result as :func:`iir_scan_apply`."""
    C, T, m = _check("iir_scan_reference", x, b, a, scale, v, sos)
    xs = _planes(x)
    ys_r, ys_i = [], []
    if sos:
        A = [[_planes(a[s, i]) for i in range(3)] for s in range(m)]
        B = [[_planes(b[s, i]) for i in range(3)] for s in range(m)]
        st = [[_planes(v[:, s, i]) for i in range(2)] for s in range(m)]
        for t in range(T):
            y = (xs[0][:, t], None if xs[1] is None else xs[1][:, t])
            for s in range(m):
                v1, v2 = st[s]
                v0 = _sub(_sub(y, _mul(A[s][1], v1)), _mul(A[s][2], v2))
                y = _add(_add(_mul(B[s][0], v0), _mul(B[s][1], v1)), _mul(B[s][2], v2))
                st[s] = [v0, v1]
            ys_r.append(y[0])
            ys_i.append(y[1])
        v_new = torch.stack([torch.stack([_join(p) for p in sec], -1) for sec in st], -2)
    else:
        A = [_planes(a[k]) for k in range(m + 1)]
        B = [_planes(b[k]) for k in range(m + 1)]
        st = [_planes(v[:, k]) for k in range(m)]
        for t in range(T):
            xt = (xs[0][:, t], None if xs[1] is None else xs[1][:, t])
            if m == 0:
                v0 = xt
                y = _mul(B[0], v0)
            else:
                s = _mul(A[1], st[0])
                for k in range(2, m + 1):
                    s = _add(s, _mul(A[k], st[k - 1]))
                v0 = _sub(xt, s)
                u = _mul(B[1], st[0])
                for k in range(2, m + 1):
                    u = _add(u, _mul(B[k], st[k - 1]))
                y = _add(_mul(B[0], v0), u)
                st = [v0] + st[:-1]
            ys_r.append(y[0])
            ys_i.append(y[1])
        v_new = torch.stack([_join(p) for p in st], -1) if m else v.clone()
    if T == 0:
        return torch.empty_like(x), v_new.to(x.dtype)
    y = (torch.stack(ys_r, -1), None if ys_i[0] is None else torch.stack(ys_i, -1))
    return _join(_mul(_planes(scale), y)), v_new.to(x.dtype)


def iir_chunked_reference(x, b, a, scale, v, *, sos: bool):
    """``iir_chunked``'s plain version: yagi_tpu's parallel route
    (``_execute_block_parallel``, ``iirfilt.py:233-266``) in torch ops, the
    log-depth all-pole scan per section, then the numerator over the state
    and the all-pole sequence, then the scale. Same arguments and result as
    :func:`iir_chunked_apply`."""
    from ..filter._linrec import allpole_parallel  # filter/ imports this module

    C, T, m = _check("iir_chunked_reference", x, b, a, scale, v, sos)
    if sos:
        y = x
        vs = []
        for s in range(m):
            v0, v_fin = allpole_parallel(a[s, 1:], v[:, s, :], y)
            # numerator: y[n] = b0·v0[n] + b1·v0[n−1] + b2·v0[n−2]
            ext = torch.cat([v[:, s].flip(-1).to(v0.dtype), v0], -1)
            y = b[s, 0] * ext[:, 2:2 + T] + b[s, 1] * ext[:, 1:1 + T] + b[s, 2] * ext[:, :T]
            vs.append(v_fin)
        v_new = torch.stack(vs, -2)
    else:
        v0, v_new = allpole_parallel(a[1:], v, x)
        ext = torch.cat([v.flip(-1).to(v0.dtype), v0], -1)
        y = b[0] * ext[:, m:m + T]
        for k in range(1, m + 1):
            y = y + b[k] * ext[:, m - k:m - k + T]
    return (y * scale).to(x.dtype), v_new.to(x.dtype)


# ------------------------------------------------------------------ kernels
def _launch(fn: str, kernel, x, b, a, scale, v, y, v_new, *extra) -> None:
    """Launch C entry point ``fn`` for the registered wrapper ``kernel``."""
    from ._build import launch

    launch(kernel, x.device, fn, x.data_ptr(), b.data_ptr(), a.data_ptr(), scale.data_ptr(),
           v.data_ptr(), y.data_ptr(), v_new.data_ptr(), *extra)


def _state_len(m: int, sos: bool) -> int:
    return 2 * m if sos else m


@trace.kernel
def iir_scan_apply(x, b, a, scale, v, *, sos: bool):
    """``iir_scan``: the sequential recurrence over a block, arguments and
    result as the module docstring says.

    CPU tensors run :func:`iir_scan_reference`; CUDA tensors launch the
    kernel (counted in ``iir_scan_apply.launches``) or raise.
    """
    C, T, m = _check("iir_scan_apply", x, b, a, scale, v, sos)
    if route(x.device, "iir_scan_apply") == "reference":
        return iir_scan_reference(x, b, a, scale, v, sos=sos)
    y = torch.empty_like(x)
    v_new = torch.empty_like(v)
    if C and T:
        inst, _ = scan_instance(_state_len(m, sos), x.is_complex(), sos)
        # the ring of the "global" instance: [state values, C] of the signal type
        scratch = (torch.empty((_state_len(m, sos), C), dtype=x.dtype, device=x.device)
                   if inst == "global" else y)
        _launch("yagi_iir_scan", iir_scan_apply, x, b, a, scale, v, y, v_new, scratch.data_ptr(),
                C, T, m, int(sos), int(x.is_complex()), int(b.is_complex()),
                SCAN_INSTANCES[inst])
        iir_scan_apply.launches += 1
    else:
        v_new.copy_(v)
    return y, v_new


@trace.kernel
def iir_chunked_apply(x, b, a, scale, v, *, sos: bool):
    """``iir_chunked``: the chunked recurrence over a block, arguments and
    result as the module docstring says.

    CPU tensors run :func:`iir_chunked_reference`; CUDA tensors launch the
    kernel (counted in ``iir_chunked_apply.launches``), or, for a shape it
    does not take (:func:`chunked_fits`), the sequential kernel through
    :func:`iir_scan_apply`; or raise.
    """
    C, T, m = _check("iir_chunked_apply", x, b, a, scale, v, sos)
    if route(x.device, "iir_chunked_apply") == "reference":
        return iir_chunked_reference(x, b, a, scale, v, sos=sos)
    order, nst = (2, m) if sos else (m, 1)
    if not chunked_fits(order, nst, x.is_complex(), b.is_complex()):
        return iir_scan_apply(x, b, a, scale, v, sos=sos)
    y = torch.empty_like(x)
    v_new = torch.empty_like(v)
    if C and T:
        _launch("yagi_iir_chunked", iir_chunked_apply, x, b, a, scale, v, y, v_new, C, T, order,
                nst, int(x.is_complex()), int(b.is_complex()),
                CHUNK_INSTANCES[chunked_instance(order)])
        iir_chunked_apply.launches += 1
    else:
        v_new.copy_(v)
    return y, v_new
