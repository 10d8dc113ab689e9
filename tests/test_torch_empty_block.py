"""Blocks of 0 samples in yagi_tpu_torch's streaming objects, against
yagi_tpu on the CPU.

A block of 0 samples returns an empty output (or, for the fixed-capacity
resamplers, zeros and a count of 0) and leaves the state as it was, so the
blocks [0, 64] equal the block of 64 alone:

* objects whose yagi_tpu counterpart handles the empty block (Agc, Symsync,
  QamRx, Firpfbch2, Firpfbchr) are held to yagi_tpu's own [0, 64] run;
* objects whose yagi_tpu counterpart loses its carried window on an empty
  block (its slice ``xa[..., len(xa) - L:]`` keeps one sample when the
  block adds none, and its gathers clamp) are held to yagi_tpu's run of the
  64-sample block alone.

Values within ``ATOL = 1e-5`` (float32 sums in another order); the
channelizers' within the rule of tests/test_torch_channelizer.py, a relative
rms of 1e-5 plus a few ulps of yagi_tpu's float32 twiddle phase; counts and
integer state exact. Inputs from ``default_rng(3)``, batch (2,).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yagi_tpu.agc as jagc
import yagi_tpu.chains as jchains
import yagi_tpu.filter as jfilter
import yagi_tpu.modem as jmodem
import yagi_tpu.multichannel as jmc
from yagi_tpu.design import FirFilterShape as JShape
import yagi_tpu_torch.agc as tagc
import yagi_tpu_torch.chains as tchains
import yagi_tpu_torch.filter as tfilter
import yagi_tpu_torch.modem as tmodem
import yagi_tpu_torch.multichannel as tmc

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

ATOL = 1e-5
BATCH = (2,)
N = 64


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.metadata.get("static", False):
            continue
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        elif isinstance(v, tuple):
            for i, e in enumerate(v):
                yield from _leaves(e, f"{prefix}{f.name}.{i}.")
        else:
            yield prefix + f.name, v


def _same_state(t, j):
    """Every tensor field of the port's state equals yagi_tpu's (the port
    may lack yagi_tpu's TPU-only fields)."""
    jl = dict(_leaves(j))
    for name, tv in _leaves(t):
        want = np.asarray(jl[name])
        got = tv.numpy()
        if np.issubdtype(want.dtype, np.inexact):
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                          err_msg=name)


def _same(got, want, phase_max=None):
    """Outputs equal; ``phase_max``: the largest twiddle phase of a
    channelizer, whose outputs are held by relative rms."""
    got = [g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        if phase_max is not None and w.size:
            rel = np.abs(g - w).max() / np.sqrt(np.mean(np.abs(w) ** 2))
            assert rel < ATOL + 4 * 2.0 ** -23 * phase_max
        elif np.issubdtype(w.dtype, np.inexact):
            np.testing.assert_allclose(g, w, atol=ATOL)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


# ---------------------------------------------------- fault 1: [0, 64] run
# name: (build(package), (yagi_tpu's package, the port's), step(obj, x) →
# (outputs..., state))
def _symsync(pkg, **kw):
    shape = JShape.RRCOS if pkg is jfilter else "rrcos"
    return pkg.Symsync.create_rnyquist(shape, 2, 7, 0.3, num_filters=32, batch_shape=BATCH, **kw)


_FAULT1 = {
    "Agc": (lambda p, **kw: p.Agc.create(bandwidth=0.01, batch_shape=BATCH, **kw),
            (jagc, tagc), lambda o, x: o.execute_block(x)),
    "Symsync": (lambda p, **kw: _symsync(p, **kw), (jfilter, tfilter),
                lambda o, x: o.execute_slots(x, backend="xla")),
    "QamRx": (lambda p, **kw: p.QamRx.create(batch_shape=BATCH, **kw), (jchains, tchains),
              lambda o, x: o.step_masked(x)),
    "Firpfbch2": (lambda p, **kw: p.Firpfbch2.create(8, 3, 60.0, batch_shape=BATCH, **kw),
                  (jmc, tmc), lambda o, x: o.analyzer_execute(x)),
    "Firpfbchr": (lambda p, **kw: p.Firpfbchr.create_kaiser(8, 2, 3, batch_shape=BATCH, **kw),
                  (jmc, tmc), lambda o, x: o.analyzer_execute(x)),
}


@pytest.mark.parametrize("name", sorted(_FAULT1))
def test_empty_block_matches_yagi_tpu_run(name):
    build, (jpkg, tpkg), step = _FAULT1[name]
    rng = np.random.default_rng(3)
    x = _cplx(rng, BATCH + (N,))
    j, t = build(jpkg), build(tpkg, device=DEV)
    for blk in (x[..., :0], x):
        *yj, j = step(j, jnp.asarray(blk))
        *yt, t = step(t, torch.from_numpy(blk))
        _same(yt, yj, 2 * np.pi * 7 * N / 8 if name.startswith("Firpfbch") else None)
    _same_state(t, j)


# ------------------------------------------- fault 2: the 64-sample block
def _fm(pkg, **kw):
    return pkg.FmStereoRx.create(kf=0.125, f_pilot=0.095, batch_shape=BATCH, **kw)


_jfm_step = jax.jit(lambda rx, x: rx.step(x))

# (build, step, input kind): "c" complex samples, "r" a real message
_FAULT2 = {
    "Resamp-1.37": (lambda p, **kw: p.Resamp.create(1.37, batch_shape=BATCH, **kw),
                    lambda o, x: o.execute_block(x, out_capacity=96), "c"),
    "Resamp-2.0": (lambda p, **kw: p.Resamp.create(2.0, batch_shape=BATCH, **kw),
                   lambda o, x: o.execute_block(x, out_capacity=136), "c"),
    "MsResamp-1.37": (lambda p, **kw: p.MsResamp.create(1.37, batch_shape=BATCH, **kw),
                      lambda o, x: o.execute_block(x), "c"),
    "FirFilter": (lambda p, **kw: p.FirFilter.create_kaiser(21, 0.2, 60.0, batch_shape=BATCH,
                                                            **kw),
                  lambda o, x: o.execute_block(x), "c"),
    "RxChain": (lambda p, **kw: p.RxChain.create(batch_shape=BATCH, **kw),
                lambda o, x: o.step(x), "c"),
    "Freqmod": (lambda p, **kw: p.Freqmod.create(0.3, batch_shape=BATCH, **kw),
                lambda o, x: o.modulate(x), "r"),
    "Freqdem": (lambda p, **kw: p.Freqdem.create(0.3, batch_shape=BATCH, **kw),
                lambda o, x: o.demodulate(x), "c"),
    "FmStereoRx": (_fm, lambda o, x: _jfm_step(o, x) if isinstance(x, jax.Array) else o.step(x),
                   "c"),
    "Modem": (lambda p, **kw: p.Modem.create("qam16", batch_shape=BATCH, **kw),
              lambda o, x: o.demodulate(x), "c"),
}
_PKG2 = {"Resamp-1.37": (jfilter, tfilter), "Resamp-2.0": (jfilter, tfilter),
         "MsResamp-1.37": (jfilter, tfilter), "FirFilter": (jfilter, tfilter),
         "RxChain": (jchains, tchains), "Freqmod": (jmodem, tmodem),
         "Freqdem": (jmodem, tmodem), "FmStereoRx": (jchains, tchains),
         "Modem": (jmodem, tmodem)}


@pytest.mark.parametrize("name", sorted(_FAULT2))
def test_empty_block_keeps_the_window(name):
    build, step, kind = _FAULT2[name]
    jpkg, tpkg = _PKG2[name]
    rng = np.random.default_rng(3)
    x = _cplx(rng, BATCH + (N,)) if kind == "c" else rng.uniform(-1, 1, BATCH + (N,)).astype(
        np.float32)
    *yj, j = step(build(jpkg), jnp.asarray(x))
    t = build(tpkg, device=DEV)
    *y0, t0 = step(t, torch.from_numpy(x[..., :0]))
    _same_state(t0, build(jpkg))  # the empty block keeps the state
    *yt, t = step(t0, torch.from_numpy(x))
    _same(yt, yj)
    _same_state(t, j)
    for y in y0:  # the empty block's outputs: no samples, or a count of 0 and zeros
        if y.is_floating_point() and y.shape == BATCH:
            continue  # a level averaged over the block (FmStereoRx's pilot): none
        assert y.numel() == 0 or not y.any()
