"""yagi_tpu_torch's config[0] receive chain against yagi_tpu's.

* fused_chain_reference (the kernel's plain torch version) against the
  Pallas kernel in interpret mode: the same banded fp32 formulation, so only
  the summation order differs (relative error below 1e-5);
* RxChain against yagi_tpu's RxChain (atol 1e-5);
* FusedRxChain against yagi_tpu's FusedRxChain and against the port's
  RxChain: the combined taps are built in float64, so the fused and staged
  chains agree within 1e-4 relative error (tests/test_fused_chain.py);
* streaming state, the ConfigError contract, and the device dispatch.

The CUDA kernel itself runs only on a GPU; chip_smoke.py holds it against
fused_chain_reference there.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.chains import FusedRxChain as JFused
from yagi_tpu.chains import RxChain as JRx
from yagi_tpu.kernels.chain import fused_chain_apply as j_apply
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.chains import FusedRxChain, RxChain
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.filter import FirFilter, Resamp
from yagi_tpu_torch.kernels import _build
from yagi_tpu_torch.kernels._check import route
from yagi_tpu_torch.kernels.chain import (chain_matrices, compact_taps, fused_chain_apply,
                                          fused_chain_apply_c64, fused_chain_reference)
from yagi_tpu_torch.nco import Osc

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

C, T = 3, 2048


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / (np.abs(a) + 1e-3)).max())


def _jfused(mix_freq, c=C):
    return JFused.create(mix_freq=mix_freq, batch_shape=(c,), r=4).replace(interpret=True)


@pytest.mark.parametrize("mix_freq", [0.0, 0.35])
def test_reference_matches_pallas_kernel(mix_freq):
    rng = np.random.default_rng(21)
    chain = FusedRxChain.create(mix_freq=mix_freq, batch_shape=(C,), device=DEV)
    xr, xi = (rng.standard_normal((C, T)).astype(np.float32) for _ in range(2))
    hr, hi = (rng.standard_normal((C, 128)).astype(np.float32) for _ in range(2))
    theta0 = np.uint32(0x9E3779B9)
    jr, ji = j_apply(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(chain.g.numpy()), jnp.asarray(hr),
        jnp.asarray(hi), theta0, np.uint32(int(chain.d_theta)), p=2, r=4, interpret=True,
    )
    tr, ti = fused_chain_reference(
        torch.from_numpy(xr), torch.from_numpy(xi), chain.g, torch.from_numpy(hr),
        torch.from_numpy(hi), torch.tensor(int(theta0)), chain.d_theta, p=2,
    )
    want = np.asarray(jr) + 1j * np.asarray(ji)
    got = tr.numpy() + 1j * ti.numpy()
    assert _rel(want, got) < 1e-5


def test_rxchain_matches_yagi_tpu():
    rng = np.random.default_rng(22)
    j = JRx.create(batch_shape=(C,))
    t = RxChain.create(batch_shape=(C,), device=DEV)
    for _ in range(3):
        x = _cplx(rng, (C, T))
        yj, kj, j = j.step(jnp.asarray(x))
        yt, kt, t = t.step(torch.from_numpy(x))
        assert int(kt) == int(np.asarray(kj)) == 2 * T
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
        assert int(t.osc.theta) == int(np.asarray(j.osc.theta))
        assert t.resamp.exact_sched == j.resamp.exact_sched


def test_rxchain_state_carries_over_from_yagi_tpu():
    """A yagi_tpu RxChain's state, loaded mid-stream, continues identically."""
    rng = np.random.default_rng(23)
    j = JRx.create(mix_freq=0.2, batch_shape=(C,))
    _, _, j = j.step(jnp.asarray(_cplx(rng, (C, 640))))
    t = RxChain(
        fir=load_state(FirFilter, _fields(j.fir), device=DEV),
        resamp=load_state(Resamp, _fields(j.resamp), device=DEV),
        osc=load_state(Osc, _fields(j.osc), device=DEV),
    )
    x = _cplx(rng, (C, 512))
    yj, kj, _ = j.step(jnp.asarray(x))
    yt, kt, _ = t.step(torch.from_numpy(x))
    assert int(kt) == int(np.asarray(kj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mix_freq", [0.0, 0.35])
def test_fused_matches_yagi_tpu_and_rxchain(mix_freq):
    rng = np.random.default_rng(7)
    jf = _jfused(mix_freq)
    tf = FusedRxChain.create(mix_freq=mix_freq, batch_shape=(C,), device=DEV)
    rx = RxChain.create(mix_freq=mix_freq, batch_shape=(C,), device=DEV)
    np.testing.assert_array_equal(tf.g.numpy(), np.asarray(jf.g))
    for blk in range(3):  # streaming state carry across blocks
        x = _cplx(rng, (C, T))
        yj, kj, jf = jf.step(jnp.asarray(x))
        yt, kt, tf = tf.step(torch.from_numpy(x))
        yr, kr, rx = rx.step(torch.from_numpy(x))
        assert kt == int(kj) == int(kr) == 2 * T
        assert _rel(yj, yt.numpy()) < 1e-4, f"block {blk} vs yagi_tpu"
        assert _rel(yr.numpy()[:, :kt], yt.numpy()) < 1e-4, f"block {blk} vs RxChain"
        assert int(tf.theta) == int(np.asarray(jf.theta))
        np.testing.assert_array_equal(tf.hist_r.numpy(), np.asarray(jf.hist_r))


def test_fused_state_carries_over_from_yagi_tpu():
    rng = np.random.default_rng(24)
    jf = _jfused(0.35)
    _, _, jf = jf.step(jnp.asarray(_cplx(rng, (C, 1024))))
    tf = load_state(FusedRxChain, _fields(jf), device=DEV)
    assert tf.theta.dtype == torch.int64 and tf.r == jf.r
    x = _cplx(rng, (C, 1024))
    yj, _, _ = jf.step(jnp.asarray(x))
    yt, _, _ = tf.step(torch.from_numpy(x))
    assert _rel(yj, yt.numpy()) < 1e-4


def test_block_split_invariance():
    """One 4096 block == two 2048 blocks (state carry exact)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_cplx(rng, (2, 4096)))
    y_all, _, _ = FusedRxChain.create(batch_shape=(2,), device=DEV).step(x)
    c2 = FusedRxChain.create(batch_shape=(2,), device=DEV)
    y_a, _, c2 = c2.step(x[:, :2048])
    y_b, _, c2 = c2.step(x[:, 2048:])
    np.testing.assert_allclose(
        y_all.numpy(), torch.cat([y_a, y_b], dim=-1).numpy(), rtol=0, atol=1e-5
    )


def test_planar_step_matches_complex_step():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_cplx(rng, (2, 1024)))
    c = FusedRxChain.create(batch_shape=(2,), device=DEV)
    y, k, _ = c.step(x)
    yr, yi, k2, _ = c.step_planar(x.real.contiguous(), x.imag.contiguous())
    assert k == k2 == 2048
    np.testing.assert_array_equal(y.real.numpy(), yr.numpy())
    np.testing.assert_array_equal(y.imag.numpy(), yi.numpy())


@pytest.mark.parametrize(
    "kw",
    [dict(rate=1.5, batch_shape=(2,)), dict(rate=3.0, batch_shape=(2,)),
     dict(batch_shape=()), dict(batch_shape=(2,), precision="bf16")],
)
def test_rejects_bad_config(kw):
    with pytest.raises(ConfigError):
        FusedRxChain.create(**kw, device=DEV)


@pytest.mark.parametrize("precision", ["highest", "high", "default", "bf16x3"])
def test_every_precision_mode_runs_fp32(precision):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_cplx(rng, (2, 256)))
    y, _, _ = FusedRxChain.create(batch_shape=(2,), precision=precision, device=DEV).step(x)
    y0, _, _ = FusedRxChain.create(batch_shape=(2,), device=DEV).step(x)
    np.testing.assert_array_equal(y.numpy(), y0.numpy())


def test_dispatch_by_device():
    assert route(torch.device("cuda", 0), "fused_chain_apply") == "cuda"
    assert route(torch.device("cpu"), "fused_chain_apply") == "reference"
    with pytest.raises(ValueError):
        route(torch.device("meta"), "fused_chain_apply")


def _apply_args(c=2, t=256):
    chain = FusedRxChain.create(batch_shape=(c,), device=DEV)
    z = torch.zeros((c, t))
    return [z, z.clone(), chain.g, chain.hist_r, chain.hist_i, chain.theta, chain.d_theta]


def test_apply_counts_no_launch_on_cpu():
    before = fused_chain_apply.launches
    fused_chain_apply(*_apply_args(), p=2)
    assert fused_chain_apply.launches == before


@pytest.mark.parametrize("bad", ["length", "dtype", "layout", "device", "phase"])
def test_apply_rejects_bad_input(bad):
    args = _apply_args()
    if bad == "length":
        args[0] = args[1] = torch.zeros((2, 200))
    elif bad == "dtype":
        args[0] = args[0].double()
    elif bad == "layout":
        args[0] = torch.zeros((256, 2)).t()
    elif bad == "device":
        args[1] = args[1].to("meta")
    else:
        args[5] = args[5].to(torch.int32)
    with pytest.raises((ValueError, TypeError)):
        fused_chain_apply(*args, p=2)


def test_kernel_build_recipe():
    """sm_90a, no fast math (sincosf must stay accurate), and a plain C
    interface without PyTorch's headers."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "fast_math" not in flags
    src = open(os.path.join(os.path.dirname(_build.__file__), "..", "csrc", "chain.cu")).read()
    assert "torch/extension.h" not in src and 'extern "C"' in src


# ------------------------------------------- any rate, the complex64 layout
@pytest.mark.parametrize("rate", [16, 32])
def test_fused_at_high_rates_matches_yagi_tpu(rate):
    """Rates past 8, which FusedRxChain.create takes as yagi_tpu's does: 3
    streamed blocks, and step (the complex64 layout) equal to step_planar
    bit for bit."""
    rng = np.random.default_rng(30 + rate)
    c, t = 2, 256
    jf = JFused.create(rate=float(rate), mix_freq=0.35, batch_shape=(c,), r=2).replace(
        interpret=True)
    tf = FusedRxChain.create(rate=float(rate), mix_freq=0.35, batch_shape=(c,), device=DEV)
    np.testing.assert_array_equal(tf.g.numpy(), np.asarray(jf.g))
    for blk in range(3):
        x = _cplx(rng, (c, t))
        yj, kj, jf = jf.step(jnp.asarray(x))
        xt = torch.from_numpy(x)
        yr, yi, kp, planar = tf.step_planar(xt.real.contiguous(), xt.imag.contiguous())
        yt, kt, tf = tf.step(xt)
        assert kt == kp == int(kj) == rate * t
        assert _rel(yj, yt.numpy()) < 1e-4, f"block {blk} vs yagi_tpu"
        assert torch.equal(yt.real, yr) and torch.equal(yt.imag, yi)
        assert torch.equal(tf.hist_r, planar.hist_r) and int(tf.theta) == int(planar.theta)
        assert int(tf.theta) == int(np.asarray(jf.theta))


@pytest.mark.parametrize("p", [1, 2, 16, 256])
def test_compact_taps_invert_chain_matrices(p):
    """compact_taps gives back the P combined filters that chain_matrices
    spread over its bands, zero padded to a multiple of 16 taps."""
    rng = np.random.default_rng(40 + p)
    h = rng.standard_normal(64)
    branches = rng.standard_normal((256, 14))
    g = chain_matrices(h, 0.4, branches, p)
    gc = compact_taps(g, p)
    k = 64 + 14 - 1
    assert gc.shape == (p, 80) and gc.dtype == np.float32
    want = np.stack([np.convolve(h * 0.4, branches[d * (256 // p)]) for d in range(p)])
    np.testing.assert_array_equal(gc[:, :k], want.astype(np.float32))
    assert not gc[:, k:].any()
    # and the bands are these taps, shifted: G[1][j, P·t + δ] = g_δ[t − j]
    np.testing.assert_array_equal(g[1, 3, 5 * p:6 * p], gc[:, 2])
    np.testing.assert_array_equal(g[0, 127, 0:p], gc[:, 1])
    np.testing.assert_array_equal(compact_taps(torch.from_numpy(g), p), gc)


def test_compact_taps_follow_the_state():
    """create and load_state both derive the kernel's taps from g, and a
    step carries them on."""
    tf = FusedRxChain.create(batch_shape=(2,), device=DEV)
    np.testing.assert_array_equal(tf.taps.numpy(), compact_taps(tf.g, 2))
    loaded = load_state(FusedRxChain, {k: v for k, v in _fields(tf).items() if k != "taps"},
                        device=DEV)
    assert torch.equal(loaded.taps, tf.taps)
    _, _, nxt = tf.step(torch.zeros((2, 128), dtype=torch.complex64))
    assert nxt.taps is tf.taps


@pytest.mark.parametrize("bad", ["dtype", "length", "hist"])
def test_apply_c64_rejects_bad_input(bad):
    xr, _, g, hr, hi, th, dth = _apply_args()
    x = torch.complex(xr, xr)
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "length":
        x = x[:, :200].contiguous()
    else:
        hr = hr[:, :64].contiguous()
    with pytest.raises((ValueError, TypeError)):
        fused_chain_apply_c64(x, g, hr, hi, th, dth, p=2)
