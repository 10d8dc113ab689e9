"""yagi_tpu_torch's config[4] channelizer against yagi_tpu's.

* Firpfbch (analysis, synthesis, streaming state) against yagi_tpu's
  Firpfbch: both run an fp32 complex IDFT matmul and sum in another order,
  so they agree within atol 1e-5 (outputs are ~10-30 in magnitude);
* fused_channelizer_reference (the kernel's plain torch version) against the
  Pallas kernel in interpret mode: the same formulation, so only the
  summation order differs: max |a − b| below 1e-5 of the output's rms. Each
  side is ~1e-5 from a float64 evaluation (outputs have an rms of ~11), so
  relative to |a| + 1e-3 sample by sample the two differ by up to ~1e-4
  wherever an output lies near 0;
* FusedChannelizer against yagi_tpu's and against the port's Firpfbch: the
  fused and unfused banks sum the IDFT in different orders and fold the 1/M
  into the twiddles, so they agree within 1e-4 relative error
  (tests/test_fused_channelizer.py);
* the slice as a whole, channelizer → FM discriminator, by wrapped phase;
* streaming state, load_state, the ConfigError contract, device dispatch;
* the sliding-transform banks Firpfbch2 (M/2 samples a step) and Firpfbchr
  (P a step): against a float64 evaluation of their definition (within 1e-5
  of the rms), and against yagi_tpu. yagi_tpu's Firpfbch2 forms its
  twiddle's phase 2π·k·e/M in float32 from the global sample index e, so its
  error grows with e (~2^-23 of the phase, 7e-3 of the rms at M = 64 after
  6,400 samples); the port takes k·e mod M and a table of the M roots of
  unity. Both are held to yagi_tpu within that growth (Firpfbchr's yagi_tpu
  twiddle reduces e mod M first, so its phase stays below 2π·M).

The CUDA kernel itself runs only on a GPU; chip_smoke.py holds it against
fused_channelizer_reference there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.kernels.channelizer import channelizer_tables as j_tables
from yagi_tpu.kernels.channelizer import fused_channelizer_apply as j_apply
from yagi_tpu.modem import Freqdem as JFreqdem
from yagi_tpu.multichannel import Firpfbch as JFirpfbch
from yagi_tpu.multichannel import Firpfbch2 as JFirpfbch2
from yagi_tpu.multichannel import Firpfbchr as JFirpfbchr
from yagi_tpu.multichannel import FusedChannelizer as JFused
from yagi_tpu.design import FirFilterShape as JFirFilterShape
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.design import FirFilterShape
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.kernels.channelizer import (
    branch_outputs,
    channelizer_tables,
    fused_channelizer_apply,
    fused_channelizer_reference,
)
from yagi_tpu_torch.modem import Freqdem
from yagi_tpu_torch.multichannel import Firpfbch, Firpfbch2, Firpfbchr, FusedChannelizer

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

M, T, R2 = 64, 256, 32  # the fused bank's channels, steps per block, TPU tile rows
KF = 0.1  # config[4]'s FM modulation factor


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / (np.abs(a) + 1e-3)).max())


def _rel_rms(a, b) -> float:
    """max |a − b| over the rms of a: fp32 rounding error of a linear bank
    scales with the signal, not with each output's own magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.sqrt(np.mean(np.abs(a) ** 2)))


def _jfused(**kw):
    return JFused.create_kaiser(M, 4, 60.0, r2=R2, **kw).replace(interpret=True)


# ------------------------------------------------------------------ Firpfbch
# M = 256 takes _idft's FFT route; its outputs reach ~40, so it also gets an
# rtol of 1e-6 (two FFT libraries, fp32 roundoff of a few ulps at that size)
@pytest.mark.parametrize("channels, rtol", [(4, 0), (8, 0), (64, 0), (256, 1e-6)])
def test_firpfbch_analysis_matches_yagi_tpu(channels, rtol):
    rng = np.random.default_rng(channels)
    j = JFirpfbch.create_kaiser(channels, 4, 60.0)
    t = Firpfbch.create_kaiser(channels, 4, 60.0, device=DEV)
    np.testing.assert_array_equal(t.branches.numpy(), np.asarray(j.branches))
    assert t.p == j.p and t.get_delay() == j.get_delay()
    for _ in range(3):  # streaming state carry across blocks
        x = _cplx(rng, channels * 96)
        yj, j = j.analyzer_execute(jnp.asarray(x))
        yt, t = t.analyzer_execute(torch.from_numpy(x))
        assert yt.dtype == torch.complex64 and yt.shape == (channels, 96)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=rtol, atol=1e-5)
        np.testing.assert_array_equal(t.raw_tail.numpy(), np.asarray(j.raw_tail))
        np.testing.assert_allclose(t.window.numpy(), np.asarray(j.window), rtol=0, atol=0)


@pytest.mark.parametrize("channels", [4, 8])
def test_firpfbch_synthesis_matches_yagi_tpu(channels):
    rng = np.random.default_rng(30 + channels)
    j = JFirpfbch.create_kaiser(channels, 4, 80.0)
    t = Firpfbch.create_kaiser(channels, 4, 80.0, device=DEV)
    for _ in range(2):
        ych = _cplx(rng, (channels, 50))
        xj, j = j.synthesizer_execute(jnp.asarray(ych))
        xt, t = t.synthesizer_execute(torch.from_numpy(ych))
        assert xt.shape == (channels * 50,)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(t.window.numpy(), np.asarray(j.window), rtol=0, atol=1e-5)


def test_firpfbch_batched_matches_yagi_tpu():
    rng = np.random.default_rng(40)
    j = JFirpfbch.create_kaiser(8, 3, 60.0, batch_shape=(2,))
    t = Firpfbch.create_kaiser(8, 3, 60.0, batch_shape=(2,), device=DEV)
    for _ in range(2):
        x = _cplx(rng, (2, 8 * 40))
        yj, j = j.analyzer_execute(jnp.asarray(x))
        yt, t = t.analyzer_execute(torch.from_numpy(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


def test_firpfbch_uneven_block_split():
    """As tests/test_channelizer.py: blocks of 16, 1, 43 and 36 steps equal
    one block of 96 (and yagi_tpu's single block)."""
    rng = np.random.default_rng(2)
    x = _cplx(rng, 8 * 96)
    y1, _ = Firpfbch.create_kaiser(8, 4, 60.0, device=DEV).analyzer_execute(torch.from_numpy(x))
    ch2, parts = Firpfbch.create_kaiser(8, 4, 60.0, device=DEV), []
    for c in np.split(x, [8 * 16, 8 * 17, 8 * 60]):
        y, ch2 = ch2.analyzer_execute(torch.from_numpy(c))
        parts.append(y.numpy())
    np.testing.assert_allclose(y1.numpy(), np.concatenate(parts, axis=-1), rtol=1e-5, atol=1e-5)
    yj, _ = JFirpfbch.create_kaiser(8, 4, 60.0).analyzer_execute(jnp.asarray(x))
    np.testing.assert_allclose(y1.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


def test_firpfbch_state_carries_over_from_yagi_tpu():
    rng = np.random.default_rng(41)
    j = JFirpfbch.create_kaiser(M, 4, 60.0)
    _, j = j.analyzer_execute(jnp.asarray(_cplx(rng, M * 20)))
    t = load_state(Firpfbch, _fields(j), device=DEV)
    assert t.window.dtype == torch.complex64 and t.raw_tail.dtype == torch.complex64
    assert t.num_channels == M and t.scale.dtype == torch.float32
    x = _cplx(rng, M * 30)
    yj, _ = j.analyzer_execute(jnp.asarray(x))
    yt, _ = t.analyzer_execute(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


def test_firpfbch_scale_and_reset():
    rng = np.random.default_rng(42)
    x = torch.from_numpy(_cplx(rng, 8 * 32))
    ch = Firpfbch.create_kaiser(8, 4, 60.0, device=DEV)
    y1, used = ch.analyzer_execute(x)
    y2, _ = ch.set_scale(2.0).analyzer_execute(x)
    np.testing.assert_allclose(y2.numpy(), 2 * y1.numpy(), rtol=1e-6, atol=1e-6)
    fresh = used.reset()
    assert not fresh.window.any() and not fresh.raw_tail.any()
    y3, _ = fresh.analyzer_execute(x)
    np.testing.assert_array_equal(y3.numpy(), y1.numpy())


@pytest.mark.parametrize(
    "make",
    [lambda: Firpfbch.create_kaiser(1, device=DEV), lambda: Firpfbch.create_kaiser(8, m=0, device=DEV),
     lambda: Firpfbch.create_kaiser(8, 3, device=DEV).analyzer_execute(
         torch.zeros(13, dtype=torch.complex64)),
     # gmsktx designs now (tests/test_torch_design_l3.py); its beta out of range does not
     lambda: Firpfbch.create_rnyquist(FirFilterShape.GMSKTX, 8, 3, 1.5, device=DEV)],
)
def test_firpfbch_rejects_bad_config(make):
    with pytest.raises(ConfigError):
        make()


@pytest.mark.parametrize("shape", ["kaiser", "rcos", "rrcos"])
def test_firpfbch_rnyquist_matches_yagi_tpu(shape):
    """The root-Nyquist prototype (fir_design_prototype) gives the same bank
    and outputs as yagi_tpu's."""
    x = _cplx(np.random.default_rng(9), 8 * 40)
    j = JFirpfbch.create_rnyquist(JFirFilterShape.from_str(shape), 8, 3, 0.3)
    t = Firpfbch.create_rnyquist(FirFilterShape.from_str(shape), 8, 3, 0.3, device=DEV)
    np.testing.assert_array_equal(t.branches.numpy(), np.asarray(j.branches))
    yj, _ = j.analyzer_execute(jnp.asarray(x))
    yt, _ = t.analyzer_execute(torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


# ------------------------------------------------------------ fused kernel
@pytest.mark.parametrize("m, scale", [(4, 1.0), (2, 0.5), (3, 2.0)])
def test_tables_match_yagi_tpu(m, scale):
    branches = Firpfbch.create_kaiser(M, m, 60.0, device=DEV).branches.numpy().astype(np.float64)
    for mine, theirs in zip(channelizer_tables(branches, scale), j_tables(branches, scale)):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_tables_are_scaled_dft_twiddles(scale):
    """The identity the card's FFT form rests on: with b(c) = (64 − c) mod 64
    the tables' W' = scale·e^{+2πi·b(c)k/64} = hr[0, 0]·e^{−2πi·ck/64}, and
    both copies of the block diagonal are the same W'."""
    branches = Firpfbch.create_kaiser(M, 4, 60.0, device=DEV).branches.numpy().astype(np.float64)
    _, hr, hi = channelizer_tables(branches, scale)
    c = np.arange(M)
    want = hr[0, 0] * np.exp(-2j * np.pi * np.outer(c, c) / M)
    for s in range(2):
        block = slice(s * M, (s + 1) * M)
        w = hr[block, block] + 1j * hi[block, block]
        assert np.abs(w - want).max() < 3e-8
    assert hr[0, 0] == np.float32(scale)


@pytest.mark.parametrize("m, scale", [(4, 1.0), (4, 0.5), (33, 1.0), (33, 0.5)])
def test_reference_is_scaled_fft_of_branch_outputs(m, scale):
    """fused_channelizer_reference (the TPU kernel's stacked twiddle dots)
    equals hr[0, 0] · the 64-point DFT of the branch outputs over the lanes,
    the form the card's kernel computes, at 8 and 66 taps a branch."""
    rng = np.random.default_rng(m)
    fz = FusedChannelizer.create_kaiser(M, m, 60.0, scale=scale, r2=1, device=DEV)
    nh = fz.hist_r.shape[0]
    xr, xi, h_r, h_i = (torch.from_numpy(rng.standard_normal(k).astype(np.float32))
                        for k in (T * M, T * M, nh, nh))
    yr, yi = fused_channelizer_reference(xr, xi, fz.taps, fz.hr, fz.hi, h_r, h_i, p=fz.p)
    ur, ui = branch_outputs(xr, xi, fz.taps, h_r, h_i, p=fz.p)
    assert ur.shape == ui.shape == (T, M)
    fft = fz.hr[0, 0] * torch.fft.fft(torch.complex(ur, ui), dim=-1)
    assert _rel_rms((yr + 1j * yi).numpy(), fft.numpy()) < 1e-5


@pytest.mark.parametrize("zero_hist", [False, True])
def test_reference_matches_pallas_kernel(zero_hist):
    rng = np.random.default_rng(21)
    fz = FusedChannelizer.create_kaiser(device=DEV)
    n = T * M
    xr, xi = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    hr, hi = (rng.standard_normal(fz.hist_r.shape[0]).astype(np.float32) * (not zero_hist)
              for _ in range(2))
    tables = [fz.taps.numpy(), fz.hr.numpy(), fz.hi.numpy()]
    jr, ji = j_apply(*map(jnp.asarray, [xr, xi, *tables, hr, hi]), p=fz.p, r2=R2,
                     interpret=True)
    tr, ti = fused_channelizer_reference(*map(torch.from_numpy, [xr, xi, *tables, hr, hi]),
                                         p=fz.p)
    assert tr.shape == ti.shape == (T, M)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    assert _rel_rms(want, tr.numpy() + 1j * ti.numpy()) < 1e-5


def test_fused_matches_yagi_tpu_and_firpfbch():
    rng = np.random.default_rng(0)
    jf = _jfused()
    tf = FusedChannelizer.create_kaiser(r2=R2, device=DEV)
    ref = Firpfbch.create_kaiser(M, 4, 60.0, device=DEV)
    np.testing.assert_array_equal(tf.taps.numpy(), np.asarray(jf.taps))
    for blk in range(3):  # streaming state carry across blocks
        x = _cplx(rng, T * M)
        yj, jf = jf.analyzer_execute(jnp.asarray(x))
        yt, tf = tf.analyzer_execute(torch.from_numpy(x))
        yr, ref = ref.analyzer_execute(torch.from_numpy(x))
        assert yt.shape == (M, T) and yt.dtype == torch.complex64
        assert _rel(yj, yt.numpy()) < 1e-4, f"block {blk} vs yagi_tpu"
        assert _rel(yr.numpy(), yt.numpy()) < 1e-4, f"block {blk} vs Firpfbch"
        np.testing.assert_array_equal(tf.hist_r.numpy(), np.asarray(jf.hist_r))
        np.testing.assert_array_equal(tf.hist_i.numpy(), np.asarray(jf.hist_i))


def test_fused_block_split_invariance():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_cplx(rng, T * M))
    y_all, _ = FusedChannelizer.create_kaiser(r2=R2, device=DEV).analyzer_execute(x)
    fz = FusedChannelizer.create_kaiser(r2=R2, device=DEV)
    ya, fz = fz.analyzer_execute(x[: 128 * M])
    yb, fz = fz.analyzer_execute(x[128 * M :])
    np.testing.assert_allclose(y_all.numpy(), torch.cat([ya, yb], dim=-1).numpy(),
                               rtol=0, atol=1e-5)


def test_fused_planar_matches_complex():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_cplx(rng, 128 * M))
    fz = FusedChannelizer.create_kaiser(r2=R2, device=DEV)
    y, _ = fz.analyzer_execute(x)
    yr, yi, _ = fz.analyzer_execute_planar(x.real.contiguous(), x.imag.contiguous())
    np.testing.assert_array_equal(y.real.numpy(), yr.numpy().T)
    np.testing.assert_array_equal(y.imag.numpy(), yi.numpy().T)


def test_fused_state_carries_over_from_yagi_tpu():
    rng = np.random.default_rng(24)
    jf = _jfused()
    _, jf = jf.analyzer_execute(jnp.asarray(_cplx(rng, T * M)))
    tf = load_state(FusedChannelizer, _fields(jf), device=DEV)
    assert (tf.p, tf.r2, tf.precision) == (jf.p, jf.r2, jf.precision)
    x = _cplx(rng, T * M)
    yj, _ = jf.analyzer_execute(jnp.asarray(x))
    yt, _ = tf.analyzer_execute(torch.from_numpy(x))
    assert _rel(yj, yt.numpy()) < 1e-4


def test_fused_state_does_not_alias_the_input():
    rng = np.random.default_rng(25)
    xr, xi = (torch.from_numpy(rng.standard_normal(T * M).astype(np.float32)) for _ in range(2))
    _, _, fz = FusedChannelizer.create_kaiser(r2=R2, device=DEV).analyzer_execute_planar(xr, xi)
    tail = fz.hist_r.clone()
    xr.zero_()  # the caller refills its buffer with the next block
    np.testing.assert_array_equal(fz.hist_r.numpy(), tail.numpy())


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_every_precision_mode_runs_fp32(precision):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_cplx(rng, 128 * M))
    y, _ = FusedChannelizer.create_kaiser(r2=R2, precision=precision, device=DEV).analyzer_execute(x)
    y0, _ = FusedChannelizer.create_kaiser(r2=R2, device=DEV).analyzer_execute(x)
    np.testing.assert_array_equal(y.numpy(), y0.numpy())


@pytest.mark.parametrize(
    "kw", [dict(num_channels=32), dict(m=0), dict(precision="bf16x3")],
)
def test_fused_rejects_bad_config(kw):
    with pytest.raises(ConfigError):
        FusedChannelizer.create_kaiser(**kw, device=DEV)


def _apply_args(n=128 * M):
    fz = FusedChannelizer.create_kaiser(r2=R2, device=DEV)
    z = torch.zeros(n)
    return [z, z.clone(), fz.taps, fz.hr, fz.hi, fz.hist_r, fz.hist_i], fz.p


def test_apply_counts_no_launch_on_cpu():
    args, p = _apply_args()
    before = fused_channelizer_apply.launches
    yr, yi = fused_channelizer_apply(*args, p=p, r2=R2)
    assert fused_channelizer_apply.launches == before
    assert yr.shape == yi.shape == (128, M)


@pytest.mark.parametrize("bad", ["length", "tile", "dtype", "layout", "device", "hist", "taps"])
def test_apply_rejects_bad_input(bad):
    args, p = _apply_args()
    if bad == "length":
        args[0] = args[1] = torch.zeros(128 * M + 64)
    elif bad == "tile":
        args[0] = args[1] = torch.zeros(R2 * 128 * 3 // 2)
    elif bad == "dtype":
        args[0] = args[0].double()
    elif bad == "layout":
        args[0] = torch.zeros(2 * 128 * M)[::2]
    elif bad == "device":
        args[1] = args[1].to("meta")
    elif bad == "hist":
        args[5] = args[5][:128]
    else:
        args[2] = args[2][:, :64]
    with pytest.raises((ValueError, TypeError)):
        fused_channelizer_apply(*args, p=p, r2=R2)


# ------------------------------------------------------- the slice as a whole
def _phase_err(m_a, m_b, y, y_prev_last) -> float:
    """Largest wrapped phase difference (radians) between two FM outputs,
    over the samples whose two discriminator inputs both have magnitude at
    least 5% of the block's rms: arg() is ill-conditioned near 0, where a
    tiny error in y turns into any angle at all."""
    mag = np.abs(y)
    mag_prev = np.concatenate([np.abs(y_prev_last)[:, None], mag[:, :-1]], axis=1)
    rms = np.sqrt(np.mean(mag ** 2))
    keep = (mag >= 0.05 * rms) & (mag_prev >= 0.05 * rms)
    d = np.angle(np.exp(1j * (m_a - m_b).astype(np.float64) * 2 * np.pi * KF))
    assert keep.mean() > 0.9  # the check is not vacuous
    return float(np.abs(d[keep]).max())


def test_slice_channelize_fm_matches_yagi_tpu():
    """config[4]: FusedChannelizer → channel-major complex → Freqdem, both
    states carried over 3 blocks, port against the yagi_tpu composition."""
    rng = np.random.default_rng(50)
    jf, jd = _jfused(), JFreqdem.create(KF, batch_shape=(M,))
    tf = FusedChannelizer.create_kaiser(r2=R2, device=DEV)
    td = Freqdem.create(KF, batch_shape=(M,), device=DEV)
    prev = np.zeros(M, np.complex64)
    for blk in range(3):
        x = _cplx(rng, T * M)
        xr, xi = (np.ascontiguousarray(v) for v in (x.real, x.imag))
        jr, ji, jf = jf.analyzer_execute_planar(jnp.asarray(xr), jnp.asarray(xi))
        mj, jd = jd.demodulate(jnp.asarray(np.asarray(jr) + 1j * np.asarray(ji)).T)
        yr, yi, tf = tf.analyzer_execute_planar(torch.from_numpy(xr), torch.from_numpy(xi))
        y = torch.complex(yr, yi).T
        mt, td = td.demodulate(y)
        assert mt.shape == (M, T) and mt.dtype == torch.float32
        assert bool(torch.isfinite(mt).all())
        assert _phase_err(mt.numpy(), np.asarray(mj), y.numpy(), prev) <= 1e-4, f"block {blk}"
        assert td.r_prime.dtype == torch.complex64
        np.testing.assert_allclose(td.r_prime.numpy(), np.asarray(jd.r_prime), rtol=0, atol=1e-4)
        prev = y.numpy()[:, -1]


def test_slice_block_split_invariance():
    rng = np.random.default_rng(51)
    x = torch.from_numpy(_cplx(rng, T * M))

    def run(blocks):
        fz, dem = FusedChannelizer.create_kaiser(r2=R2, device=DEV), Freqdem.create(KF, (M,), device=DEV)
        ys, ms = [], []
        for b in blocks:
            y, fz = fz.analyzer_execute(b)
            m, dem = dem.demodulate(y)
            ys.append(y)
            ms.append(m)
        return torch.cat(ms, dim=-1).numpy(), torch.cat(ys, dim=-1).numpy()

    m_all, y_all = run([x])
    m_split, y_split = run([x[: 128 * M], x[128 * M :]])
    np.testing.assert_allclose(y_all, y_split, rtol=0, atol=1e-5)
    assert _phase_err(m_all, m_split, y_all, np.zeros(M, np.complex64)) <= 1e-4


# ------------------------------------------------ banks past 64 taps a branch
def test_fused_with_66_taps_a_branch_matches_yagi_tpu():
    """create_kaiser(m=33): p = 66, which the card runs on the kernel's
    tiled instance; two streamed blocks against yagi_tpu and Firpfbch (64
    rows a tile: yagi_tpu's tiles must hold the 33 rows of history)."""
    rng = np.random.default_rng(5)
    jf = JFused.create_kaiser(M, 33, 60.0, r2=64).replace(interpret=True)
    tf = FusedChannelizer.create_kaiser(m=33, r2=64, device=DEV)
    ref = Firpfbch.create_kaiser(M, 33, 60.0, device=DEV)
    assert tf.p == jf.p == 66
    np.testing.assert_array_equal(tf.taps.numpy(), np.asarray(jf.taps))
    for blk in range(2):
        x = _cplx(rng, T * M)
        yj, jf = jf.analyzer_execute(jnp.asarray(x))
        yt, tf = tf.analyzer_execute(torch.from_numpy(x))
        yr, ref = ref.analyzer_execute(torch.from_numpy(x))
        assert _rel_rms(np.asarray(yj), yt.numpy()) < 1e-5, f"block {blk} vs yagi_tpu"
        assert _rel_rms(yr.numpy(), yt.numpy()) < 1e-5, f"block {blk} vs Firpfbch"
        np.testing.assert_array_equal(tf.hist_r.numpy(), np.asarray(jf.hist_r))


# ------------------------------------------------------- Firpfbch2, Firpfbchr
def _taps(bank) -> np.ndarray:
    """The prototype h[j] = branches[j mod M, j // M], float64."""
    br = bank.branches.numpy().astype(np.float64)
    M = br.shape[0]
    return np.array([br[j % M, j // M] for j in range(br.size)])


def _direct(x, h, M: int, P: int, T: int, e0: int = 0) -> np.ndarray:
    """y_k[t] = Σ_j h[j]·x[e_t − j]·e^{−j2πk(e_t − j)/M} in float64, with
    e_t = (t+1)·P − 1 counted from the stream start (e0 samples before x)."""
    n = np.arange(x.size) + e0
    e = (np.arange(T) + 1) * P - 1
    out = np.zeros((M, T), np.complex128)
    for k in range(M):
        out[k] = np.convolve(x * np.exp(-2j * np.pi * k * n / M), h)[e]
    return out


@pytest.mark.parametrize("channels", [8, 16, 64])
def test_firpfbch2_matches_its_definition(channels):
    """Streamed in three blocks: the step parity and the twiddle follow the
    global sample index across blocks."""
    rng = np.random.default_rng(70 + channels)
    bank = Firpfbch2.create(channels, 4, 60.0, device=DEV)
    half, steps = channels // 2, (13, 40, 7)
    x = _cplx(rng, half * sum(steps))
    ys, pos = [], 0
    for n in steps:
        y, bank = bank.analyzer_execute(torch.from_numpy(x[pos:pos + n * half]))
        assert y.shape == (channels, n) and y.dtype == torch.complex64
        ys.append(y.numpy())
        pos += n * half
    assert int(bank.step_parity) == sum(steps) % 2
    want = _direct(x.astype(np.complex128), _taps(bank), channels, half, sum(steps))
    assert _rel_rms(want, np.concatenate(ys, axis=-1)) < 1e-5


@pytest.mark.parametrize("channels", [8, 64])
def test_firpfbch2_matches_yagi_tpu(channels):
    rng = np.random.default_rng(80 + channels)
    j = JFirpfbch2.create(channels, 4, 60.0)
    t = Firpfbch2.create(channels, 4, 60.0, device=DEV)
    np.testing.assert_array_equal(t.branches.numpy(), np.asarray(j.branches))
    half, pos = channels // 2, 0
    for n in (25, 50):
        x = _cplx(rng, n * half)
        yj, j = j.analyzer_execute(jnp.asarray(x))
        yt, t = t.analyzer_execute(torch.from_numpy(x))
        pos += n * half
        # yagi_tpu's float32 phase 2πk·e/M: a few ulps of the largest phase
        phase_max = 2 * np.pi * (channels - 1) * pos / channels
        assert _rel_rms(np.asarray(yj), yt.numpy()) < 1e-5 + 4 * 2.0 ** -23 * phase_max
        assert int(t.step_parity) == int(j.step_parity)
        np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))


def test_firpfbch2_tone_isolation_and_errors():
    """liquid firpfbch2_crcf_n*: a tone at channel k's centre lands in k."""
    for channels in (8, 64):
        bank = Firpfbch2.create(channels, 4, 60.0, device=DEV)
        t = np.arange(256 * channels // 2)
        for k in (0, 2, channels - 3):
            x = np.exp(2j * np.pi * (k / channels) * t).astype(np.complex64)
            y, _ = bank.analyzer_execute(torch.from_numpy(x))
            p = (y[:, 32:].abs() ** 2).mean(dim=-1).numpy()
            assert p.argmax() == k and np.sort(p)[-2] / p.max() < 1e-5
    with pytest.raises(ConfigError):
        Firpfbch2.create(7, device=DEV)
    with pytest.raises(ConfigError):
        Firpfbch2.create(8, device=DEV).analyzer_execute(torch.zeros(6, dtype=torch.complex64))
    bank = Firpfbch2.create(8, device=DEV).analyzer_execute(torch.ones(12, dtype=torch.complex64))[1]
    assert int(bank.step_parity) == 1 and int(bank.reset().step_parity) == 0
    assert not bool(bank.reset().hist.any())


@pytest.mark.parametrize("channels, decim", [(8, 8), (8, 5), (16, 5), (12, 12), (20, 7)])
def test_firpfbchr_matches_its_definition_and_yagi_tpu(channels, decim):
    rng = np.random.default_rng(channels * 100 + decim)
    j = JFirpfbchr.create_kaiser(channels, decim, m=3, as_=60.0)
    t = Firpfbchr.create_kaiser(channels, decim, m=3, as_=60.0, device=DEV)
    assert t.get_delay() == j.get_delay()
    x = _cplx(rng, decim * 60)
    ys = []
    for blk in (x[: decim * 17], x[decim * 17:]):
        yj, j = j.analyzer_execute(jnp.asarray(blk))
        yt, t = t.analyzer_execute(torch.from_numpy(blk))
        # yagi_tpu reduces e mod M, then forms 2πk·e/M in float32: k·e < M²
        phase_max = 2 * np.pi * (channels - 1) ** 2 / channels
        assert _rel_rms(np.asarray(yj), yt.numpy()) < 1e-5 + 4 * 2.0 ** -23 * phase_max
        assert int(t.sample_count) == int(j.sample_count)
        np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
        ys.append(yt.numpy())
    want = _direct(x.astype(np.complex128), _taps(t), channels, decim, 60)
    assert _rel_rms(want, np.concatenate(ys, axis=-1)) < 1e-5


def test_firpfbchr_tone_scale_and_errors():
    bank = Firpfbchr.create_kaiser(16, 8, m=4, as_=80.0, device=DEV)
    n = np.arange(128 * 8)
    y, _ = bank.analyzer_execute(torch.from_numpy(np.exp(2j * np.pi * 3 / 16 * n).astype(np.complex64)))
    pwr = (y[:, 32:].abs() ** 2).mean(dim=-1).numpy()
    assert pwr.argmax() == 3 and 10 * np.log10(np.delete(pwr, 3).max() / pwr[3]) < -50.0
    y2, _ = bank.set_scale(0.5).analyzer_execute(torch.from_numpy(np.exp(2j * np.pi * 3 / 16 * n)
                                                                 .astype(np.complex64)))
    torch.testing.assert_close(y2, 0.5 * y)
    for args in ((1, 1), (8, 0), (8, 9)):
        with pytest.raises(ConfigError):
            Firpfbchr.create_kaiser(*args, device=DEV)
    with pytest.raises(ConfigError):
        bank.analyzer_execute(torch.zeros(7, dtype=torch.complex64))
