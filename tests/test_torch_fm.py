"""yagi_tpu_torch's FmStereoRx (BASELINE config[2]: Freqdem → four 129-tap
FIRs → pilot-tone stereo matrix → two first-order de-emphasis IIRs on the
parallel route) and the rest of FirFilter against yagi_tpu, on the CPU.

The FIRs are banded matmuls in the port and XLA convolutions in yagi_tpu,
and the de-emphasis runs the log-depth scan in another tree: outputs and
carried state agree within ``ATOL = 1e-5`` (measured ≤ 1.5e-7 on L and R,
whose peak is ~0.46, and ≤ 1e-6 on the state), the pilot level likewise.
Taps and design values are host float64 copies: equal. The stereo decoding
itself (tone amplitudes within 5%, separation above 40 dB) is checked on the
port alone, as tests/test_aux.py checks yagi_tpu. On the card, chip_smoke.py
holds the chain against itself with the de-emphasis on its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.chains import FmStereoRx as JFm
from yagi_tpu.design import FirFilterShape as JShape
from yagi_tpu.filter import FirFilter as JFir
from yagi_tpu.modem import Freqmod as JFreqmod
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.chains import FmStereoRx
from yagi_tpu_torch.design import FirFilterShape
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.filter import FirFilter
from yagi_tpu_torch.modem import Freqmod
from yagi_tpu_torch.tools import paths

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

ATOL = 1e-5
C, N = 4, 1 << 12  # tests/test_aux.py's batched case: two blocks of N/2
FP = 0.095

_jstep = jax.jit(lambda rx, x: rx.step(x))


def _leaves(obj, prefix=""):
    """(dotted name, value) of every field, nested objects walked."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        else:
            yield prefix + f.name, v


def _same_state(t, j, atol=ATOL):
    tl, jl = dict(_leaves(t)), dict(_leaves(j))
    assert sorted(tl) == sorted(jl)
    for name, tv in tl.items():
        jv = jl[name]
        if isinstance(tv, torch.Tensor):
            jv = np.asarray(jv)
            if name == "pilot_bp.window" and not tv.is_complex():
                # the port carries the real composite as float32, yagi_tpu as
                # complex64 with no imaginary part
                assert not jv.imag.any(), name
                jv = jv.real
            assert tv.shape == jv.shape and tv.numpy().dtype == jv.dtype, name
            np.testing.assert_allclose(tv.numpy(), jv, atol=atol, rtol=0, err_msg=name)
        else:
            assert tv == jv, name


@pytest.fixture(scope="module")
def stereo_iq():
    """C channels of FM-modulated composite: a mono tone each, the pilot, and
    a difference tone on the 38 kHz subcarrier (kf 0.25)."""
    t = np.arange(N)
    comps = [0.5 * np.sin(2 * np.pi * (0.008 + 0.002 * c) * t) + 0.1 * np.cos(2 * np.pi * FP * t)
             + 0.2 * np.sin(2 * np.pi * 0.013 * t) * np.cos(2 * np.pi * 2 * FP * t)
             for c in range(C)]
    return np.stack([np.asarray(JFreqmod.create(0.25).modulate((m * 0.5).astype(np.float32))[0])
                     for m in comps])


def test_batched_streaming_matches_yagi_tpu(stereo_iq):
    """tests/test_aux.py's batched config[2] case: C = 4 channels, two
    streamed blocks of 2^11; L, R, the pilot level and every state field."""
    j = JFm.create(kf=0.125, f_pilot=FP, batch_shape=(C,))
    t = FmStereoRx.create(kf=0.125, f_pilot=FP, batch_shape=(C,), device=DEV)
    _same_state(t, j, atol=0)
    blk = N // 2
    for b in range(2):
        x = stereo_iq[:, b * blk:(b + 1) * blk]
        *jo, j = _jstep(j, jnp.asarray(x))
        *to, t = t.step(torch.from_numpy(x))
        for name, tv, jv in zip(("left", "right", "pilot_level"), to, jo):
            assert tv.dtype == torch.float32 and tuple(tv.shape) == np.shape(jv), name
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0,
                                       err_msg=name)
        _same_state(t, j)
    assert t.deemph_l.parallel and t.deemph_r.parallel and not t.deemph_l.sos_form


def test_load_state_carries_the_chain_mid_stream(stereo_iq):
    """load_state builds the port's chain from yagi_tpu's mid-stream (the
    nested FirFilters, Freqdem and IirFilters, static fields unchanged); both
    continue alike."""
    blk = N // 2
    j = JFm.create(kf=0.125, f_pilot=FP, batch_shape=(C,))
    *_, j = _jstep(j, jnp.asarray(stereo_iq[:, :blk]))
    t = load_state(FmStereoRx, j, device=DEV)
    _same_state(t, j, atol=0)
    x = stereo_iq[:, blk:]
    *jo, j = _jstep(j, jnp.asarray(x))
    *to, t = t.step(torch.from_numpy(x))
    for tv, jv in zip(to, jo):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    _same_state(t, j)


def test_block_split_and_plain_oracle(stereo_iq):
    """One block equals two halves within 1e-5 of the peak (the de-emphasis
    runs the log-depth scan, whose tree depends on the length); the chain's
    plain oracle equals ``step`` on the CPU, where the wrappers run it."""
    x = torch.from_numpy(stereo_iq)
    rx = FmStereoRx.create(kf=0.125, f_pilot=FP, batch_shape=(C,), device=DEV)
    one = rx.step(x)
    a = rx.step(x[:, :N // 2])
    b = a[3].step(x[:, N // 2:])
    for k in (0, 1):
        whole, parts = one[k], torch.cat([a[k], b[k]], -1)
        assert (whole - parts).abs().max() <= 1e-5 * whole.abs().max()
    plain = rx._step(x, plain=True)
    for p, s in zip(plain[:3], one[:3]):
        assert torch.equal(p, s)


def test_stereo_separation():
    """tests/test_aux.py's stereo test on the port: L and R tones recovered
    within 5% and separated by more than 40 dB, n = 2^15."""
    n = 1 << 15
    t = np.arange(n)
    L = 0.8 * np.sin(2 * np.pi * 0.010 * t)
    R = 0.5 * np.sin(2 * np.pi * 0.021 * t)
    comp = 0.5 * (L + R) + 0.1 * np.cos(2 * np.pi * FP * t) + 0.5 * (L - R) * np.cos(
        2 * np.pi * 2 * FP * t)
    iq, _ = Freqmod.create(0.25, device=DEV).modulate(torch.from_numpy((comp * 0.5).astype(np.float32)))
    rx = FmStereoRx.create(kf=0.125, f_pilot=FP, deemph_alpha=1.0, device=DEV)
    left, right, _, _ = rx.step(iq)
    left, right = left.numpy(), right.numpy()
    d = 600

    def amp(x, f):
        return 2 * np.abs(np.mean(x[d:] * np.exp(-2j * np.pi * f * t[d:])))

    assert amp(left, 0.010) == pytest.approx(0.8, rel=0.05)
    assert amp(right, 0.021) == pytest.approx(0.5, rel=0.05)
    assert 20 * np.log10(amp(left, 0.010) / amp(left, 0.021)) > 40
    assert 20 * np.log10(amp(right, 0.021) / amp(right, 0.010)) > 40


def test_deemphasis_rolloff():
    rx = FmStereoRx.create(deemph_alpha=0.05, device=DEV)
    assert abs(rx.deemph_l.freqresponse(0.0)) == pytest.approx(1.0, rel=1e-3)
    assert abs(rx.deemph_l.freqresponse(0.05)) < 0.3


def test_create_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        FmStereoRx.create()
    rx = FmStereoRx.create(batch_shape=(2,), device=DEV)
    assert {v.device.type for _, v in _leaves(rx) if isinstance(v, torch.Tensor)} == {"cpu"}


def test_config2_input_is_bench_py_s():
    """tools/paths.py's config[2] block is bench.py:208-210's draw."""
    shape = (3, 40)
    rng = np.random.default_rng(paths.FM_SEED)
    want = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64) * 0.1
    got = paths.fm_block(np.random.default_rng(paths.FM_SEED), shape, DEV)
    assert got.dtype == torch.complex64 and np.array_equal(got.numpy(), want)
    assert (paths.C2, paths.T2, paths.FM_SEED) == (512, 1 << 14, 3)
    assert paths.make_fmstereo(2, DEV).mono_lp.h.shape == (129,)


# ------------------------------------------------------- FirFilter, the rest
_FIR_CTORS = [
    ("create_rnyquist", lambda s: (s.RRCOS, 2, 7, 0.3), {}),
    ("create_rnyquist", lambda s: (s.RCOS, 4, 3, 0.25, 0.1), {}),
    ("create_firdespm", lambda s: (31, 0.2, 60.0), {}),
    ("create_rect", lambda s: (9,), {}),
    ("create_dc_blocker", lambda s: (7, 40.0), {}),
    ("create_notch", lambda s: (8, 50.0, 0.2), {}),
    ("create_notch", lambda s: (8, 50.0, 0.2), {"complex": True}),
]


@pytest.mark.parametrize("ctor, args, opts", _FIR_CTORS)
def test_fir_constructors_match_yagi_tpu(ctor, args, opts):
    """Taps, scale, window and the analysis of each constructor."""
    jkw, tkw = {}, {"device": DEV}
    if opts.get("complex"):
        jkw["dtype"], tkw["dtype"] = jnp.complex64, torch.complex64
    j = getattr(JFir, ctor)(*args(JShape), **jkw)
    t = getattr(FirFilter, ctor)(*args(FirFilterShape), **tkw)
    assert t.h.numpy().dtype == np.asarray(j.h).dtype
    np.testing.assert_array_equal(t.h.numpy(), np.asarray(j.h))
    assert t.window.shape == j.window.shape and t.window.numpy().dtype == np.asarray(j.window).dtype
    assert t.h_len == len(t) == j.h_len and t.get_scale().item() == complex(np.asarray(j.get_scale()))
    for fc in (0.0, 0.1, 0.33):
        np.testing.assert_allclose(t.freqresponse(fc), j.freqresponse(fc), rtol=1e-9, atol=1e-12)
        if abs(t.freqresponse(fc)) > 1e-3:
            assert t.groupdelay(fc) == pytest.approx(j.groupdelay(fc), rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("ctor, args", [
    ("create_rect", (0,)), ("create_rect", (1025,)), ("create_dc_blocker", (0, 40.0)),
    ("create_notch", (4, 40.0, 0.7)), ("create_notch", (4, -1.0, 0.1)),
    ("create_firdespm", (31, 0.7, 60.0)), ("create", ([],)),
])
def test_fir_constructors_reject_what_yagi_tpu_rejects(ctor, args):
    from yagi_tpu.errors import ConfigError as JConfigError

    with pytest.raises(JConfigError):
        getattr(JFir, ctor)(*args)
    with pytest.raises(ConfigError):
        getattr(FirFilter, ctor)(*args, device=DEV)


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_fir_sample_api_matches_yagi_tpu(dtype):
    """push, write, execute, execute_one and reset against yagi_tpu, and
    against execute_block's outputs."""
    rng = np.random.default_rng(12)
    h = rng.standard_normal(9).astype(np.float32)
    cx = dtype == "complex64"
    j = JFir.create(h, batch_shape=(2,), dtype=jnp.dtype(dtype)).set_scale(0.5)
    t = FirFilter.create(h, batch_shape=(2,), dtype=getattr(torch, dtype), device=DEV).set_scale(0.5)
    x = rng.standard_normal((2, 30)) + (1j * rng.standard_normal((2, 30)) if cx else 0)
    x = x.astype(dtype)
    j, t = j.write(jnp.asarray(x[:, :12])), t.write(torch.from_numpy(x[:, :12]))
    np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))
    ys = []
    for i in range(12, 30):
        yj, j = j.execute_one(jnp.asarray(x[:, i]))
        yt, t = t.execute_one(torch.from_numpy(x[:, i]))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, rtol=0)
        ys.append(yt)
    t = t.push(torch.from_numpy(x[:, 0]))
    j = j.push(jnp.asarray(x[:, 0]))
    np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))
    np.testing.assert_allclose(t.execute().numpy(), np.asarray(j.execute()), atol=ATOL, rtol=0)
    yb, _ = FirFilter.create(h, batch_shape=(2,), dtype=getattr(torch, dtype),
                             device=DEV).set_scale(0.5).execute_block(torch.from_numpy(x))
    np.testing.assert_allclose(torch.stack(ys, -1).numpy(), yb[:, 12:].numpy(), atol=ATOL, rtol=0)
    assert not t.reset().window.any() and t.reset().window.shape == (2, 9)
