"""The CVSD codec and checkpoint / restore of yagi_tpu_torch against
yagi_tpu (audio/cvsd.py, utils/checkpoint.py).

Cvsd: the same numpy-seeded audio goes through yagi_tpu's codec and the
port's (on the CPU). Tolerances, and why:

* the encoded bits, and the encoder's state (ref, delta, bitref,
  pre_state): exactly. The step decay divides by zeta, which XLA compiles
  as a multiply by the float32 1/zeta; the port multiplies the same way;
* the decoded audio and the decoder's post_state: within 1e-6. yagi_tpu's
  XLA CPU backend contracts the de-emphasis ref + α·y[n−1] (cvsd.py:132)
  into a fused multiply-add, the port rounds the product alone (as on the
  card), so the two differ by a few ulps, bounded by the de-emphasis gain
  1/(1 − α); the decoder's ref, delta and bitref exactly;
* the port's block splits (and card against CPU): bit for bit.

Checkpoint: the port's counterparts of tests/test_checkpoint.py's 24 types,
run 300 samples, saved to disk, restored into a fresh object, run 300
more: outputs and every leaf bit-identical to the uninterrupted run.
"""

import numpy as np
import pytest
import torch

from yagi_tpu.audio import Cvsd as JCvsd
from yagi_tpu_torch._src import struct
from yagi_tpu_torch._src.struct import load_state as carry_state
from yagi_tpu_torch.agc import Agc
from yagi_tpu_torch.audio import Cvsd
from yagi_tpu_torch.chains import FmStereoRx, QamRx
from yagi_tpu_torch.design import FirFilterShape
from yagi_tpu_torch.equalization import Eqlms, Eqrls
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.fft import Spgram, Spwaterfall
from yagi_tpu_torch.filter import (FftFilt, FirFarrow, FirFilter, IirFilter, IirFilterSos,
                                   MsResamp, MsResamp2, Resamp, Resamp2, Symsync)
from yagi_tpu_torch.modem import Freqdem, Freqmod, Fskdem, GmskDem
from yagi_tpu_torch.multichannel import Firpfbch, Firpfbch2
from yagi_tpu_torch.nco import Osc
from yagi_tpu_torch.tools.paths import make_channelizer, make_fused
from yagi_tpu_torch.utils import load_state, save_state, state_leaves

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
AUDIO_TOL = 1e-6


def _sine(n=4000, f=220.0, fs=8000.0, amp=0.5):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / fs)).astype(np.float32)


def _audio(seed=0, n=4000):
    """Three channels: tests/test_audio.py's sine, noise and a louder sine."""
    rng = np.random.default_rng(seed)
    return np.stack([_sine(n), (0.3 * rng.standard_normal(n)).astype(np.float32),
                     _sine(n, 700.0, amp=0.9)])


# ------------------------------------------------------------------ Cvsd
@pytest.mark.parametrize("num_bits,zeta,alpha", [(4, 1.5, 0.9), (8, 1.5, 0.9), (3, 2.0, 0.5),
                                                 (4, 1.5, 0.0)])
def test_cvsd_matches(num_bits, zeta, alpha):
    """Encode then decode three channels of 4000 samples: bits and the
    encoder's state equal yagi_tpu's; the audio and post_state within
    AUDIO_TOL; the decoder's ref, delta and bitref exactly."""
    x = _audio()
    jb, je = JCvsd.create(num_bits, zeta, alpha, batch_shape=(3,)).encode(x)
    tb, te = Cvsd.create(num_bits, zeta, alpha, batch_shape=(3,), device=DEV).encode(x)
    assert tb.dtype == torch.uint8 and tb.shape == (3, 4000)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for f in ("ref", "delta", "bitref", "pre_state"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)), f)
    jy, jd = JCvsd.create(num_bits, zeta, alpha, batch_shape=(3,)).decode(np.asarray(jb))
    ty, td = Cvsd.create(num_bits, zeta, alpha, batch_shape=(3,), device=DEV).decode(tb)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=AUDIO_TOL)
    np.testing.assert_allclose(td.post_state.numpy(), np.asarray(jd.post_state), rtol=0,
                               atol=AUDIO_TOL)
    for f in ("ref", "delta", "bitref"):
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), f)


def test_cvsd_quality_and_self_sync():
    """tests/test_audio.py's checks on the port: SNR > 12 dB and rmse < 0.2
    on the sine; the bits balanced; with no emphasis the decoder's ref
    equals the encoder's bit for bit."""
    x = _sine()
    bits, _ = Cvsd.create(4, 1.5, 0.9, device=DEV).encode(x)
    y, _ = Cvsd.create(4, 1.5, 0.9, device=DEV).decode(bits)
    err = y.numpy()[500:] - x[500:]
    assert 10 * np.log10(np.mean(x[500:] ** 2) / np.mean(err ** 2)) > 12.0
    assert np.sqrt(np.mean(err ** 2)) < 0.2
    assert abs(float(bits.float().mean()) - 0.5) < 0.02
    bits, enc = Cvsd.create(4, 1.5, 0.0, device=DEV).encode(x[:1000])
    _, dec = Cvsd.create(4, 1.5, 0.0, device=DEV).decode(bits)
    assert torch.equal(enc.ref, dec.ref) and torch.equal(enc.delta, dec.delta)


def test_cvsd_split_invariance_and_carry_over():
    """Blocks [100, 1, 2399, 0, 1500] equal one block bit for bit (bits,
    audio, state); a yagi_tpu codec stopped after 1700 samples continues in
    the port (load_state) with yagi_tpu's bits."""
    x = _audio(1)
    enc, dec = Cvsd.create(batch_shape=(3,), device=DEV), Cvsd.create(batch_shape=(3,), device=DEV)
    b1, e1 = enc.encode(x)
    y1, d1 = dec.decode(b1)
    bs, ys = [], []
    for c in np.split(x, [100, 101, 2500, 2500], axis=1):
        b, enc = enc.encode(c)
        y, dec = dec.decode(b)
        bs.append(b)
        ys.append(y)
    assert torch.equal(torch.cat(bs, 1), b1) and torch.equal(torch.cat(ys, 1), y1)
    for f in ("ref", "delta", "bitref", "pre_state", "post_state"):
        assert torch.equal(getattr(enc, f), getattr(e1, f)) and torch.equal(
            getattr(dec, f), getattr(d1, f)), f
    je = JCvsd.create(batch_shape=(3,))
    _, je = je.encode(x[:, :1700])
    te = carry_state(Cvsd, je, DEV)
    assert te.bitref.dtype == torch.int64
    jb, _ = je.encode(x[:, 1700:])
    tb, _ = te.encode(x[:, 1700:])
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_cvsd_config_errors_and_default_device():
    for kw in ({"num_bits": 0}, {"zeta": 1.0}, {"alpha": 1.0}, {"alpha": -0.1}):
        with pytest.raises(ConfigError):
            Cvsd.create(device=DEV, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            Cvsd.create()


# ------------------------------------------------------------------ checkpoint
def _cx(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64))


def _re(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def _cut(m):
    return lambda n, seed=0: _cx(n - n % m, seed)


_H9 = np.arange(1, 10, dtype=np.float32) / 10.0


def _outs(*r):
    """(outputs tuple, state) from a call returning (outputs..., state)."""
    return tuple(r[:-1]), r[-1]


# (factory, step(state, block) -> (outputs, state), input generator):
# tests/test_checkpoint.py's 24 cases on the port
CASES = {
    "resamp_arbitrary": (lambda: Resamp.create(0.7153, device=DEV),
                         lambda s, x: _outs(*s.execute_block(x)), _cx),
    "resamp_fastpath": (lambda: Resamp.create(2.0, device=DEV),
                        lambda s, x: _outs(*s.execute_block(x)), _cx),
    "resamp2_analyzer": (lambda: Resamp2.create(7, device=DEV),
                         lambda s, x: _outs(*s.analyzer_execute_block(x)), _cx),
    "msresamp": (lambda: MsResamp.create(0.37, 60.0, device=DEV),
                 lambda s, x: _outs(*s.execute_block(x)), _cx),
    "msresamp2_decim": (lambda: MsResamp2.create(False, 2, 0.4, 0.0, 60.0, device=DEV),
                        lambda s, x: _outs(*s.execute_block(x)), _cut(4)),
    "symsync": (lambda: Symsync.create_rnyquist(FirFilterShape.RRCOS, 2, 7, 0.3,
                                                device=DEV).set_lf_bw(0.02),
                lambda s, x: _outs(*s.execute(x)), _cx),
    "agc": (lambda: Agc.create(device=DEV).set_bandwidth(0.01),
            lambda s, x: _outs(*s.execute_block(x)), _cx),
    "osc_mix": (lambda: Osc.create("nco", device=DEV).set_frequency(0.31),
                lambda s, x: _outs(*s.mix_block_down(x)), _cx),
    "eqlms": (lambda: Eqlms.create(h_len=7, device=DEV).set_bw(0.02),
              lambda s, x: _outs(*s.execute_block(2, x)), _cx),
    "eqrls": (lambda: Eqrls.create(p=5, device=DEV),
              lambda s, x: _outs(*s.train_block(x, 0.5 * x)), _cx),
    "firfilt": (lambda: FirFilter.create(_H9, dtype=torch.complex64, device=DEV),
                lambda s, x: _outs(*s.execute_block(x)), _cx),
    "fftfilt": (lambda: FftFilt.create(_H9, 64, dtype=torch.complex64, device=DEV),
                lambda s, x: _outs(*s.execute_blocks(x)), _cut(128)),
    "firfarrow": (lambda: FirFarrow.create(9, 4, 0.45, 40.0, device=DEV).set_delay(0.3),
                  lambda s, x: _outs(*s.execute_block(x)), _cx),
    "iirfilt": (lambda: IirFilter.create_lowpass(5, 0.1, dtype=torch.complex64, device=DEV),
                lambda s, x: _outs(*s.execute_block(x)), _cx),
    "iirfiltsos": (lambda: IirFilterSos.create([0.2, 0.4, 0.2], [1.0, -0.5, 0.1],
                                               dtype=torch.complex64, device=DEV),
                   lambda s, x: _outs(*s.execute_block(x)), _cx),
    "spgram": (lambda: Spgram.create(64, device=DEV), lambda s, x: ((), s.write(x)), _cx),
    "firpfbch_analyzer": (lambda: Firpfbch.create_kaiser(4, 5, 60.0, device=DEV),
                          lambda s, x: _outs(*s.analyzer_execute(x)), _cut(4)),
    "firpfbch2_analyzer": (lambda: Firpfbch2.create(4, 3, 60.0, device=DEV),
                           lambda s, x: _outs(*s.analyzer_execute(x)), _cut(2)),
    "qamrx": (lambda: QamRx.create(device=DEV), lambda s, x: _outs(*s.step(x)), _cut(4)),
    "fm_stereo": (lambda: FmStereoRx.create(device=DEV), lambda s, x: _outs(*s.step(x)),
                  lambda n, seed=0: _cut(16)(n, seed) * 0.1),
    "freqdem": (lambda: Freqdem.create(0.1, device=DEV),
                lambda s, x: _outs(*s.demodulate(x)), _cx),
    "freqmod": (lambda: Freqmod.create(0.1, device=DEV),
                lambda s, x: _outs(*s.modulate(x)), _re),
    "gmskdem": (lambda: GmskDem.create(4, 3, 0.3, device=DEV),
                lambda s, x: _outs(*s.demodulate(x)), _cut(4)),
    "fskdem": (lambda: Fskdem.create(2, 8, 0.25, device=DEV),
               lambda s, x: _outs(*s.demodulate(x)), _cut(8)),
}


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoint_roundtrip(tmp_path, name):
    """Run N, save to disk, restore into a fresh object, run M: outputs and
    every leaf of the final state bit-identical to the uninterrupted run,
    each leaf on the template's device and dtype."""
    assert len(CASES) == 24
    factory, step, gen = CASES[name]
    x = gen(600, seed=42)
    b1, b2 = x[: x.shape[0] // 2], x[x.shape[0] // 2:]
    _, s = step(factory(), b1)
    ref_out, ref_state = step(s, b2)
    _, s2 = step(factory(), b1)
    path = tmp_path / f"{name}.npz"
    save_state(path, s2)
    restored = load_state(path, factory())
    assert len(state_leaves(restored)) == len(state_leaves(s2))
    got_out, got_state = step(restored, b2)
    assert len(ref_out) == len(got_out)
    for a, b in zip(ref_out, got_out):
        assert _equal(a, b)
    assert state_leaves(ref_state)
    for a, b in zip(state_leaves(ref_state), state_leaves(got_state)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_checkpoint_rejects_mismatched_template(tmp_path):
    """A template of another type, batch shape or dtype, or a file that is
    not a checkpoint, raises ValueError."""
    path = tmp_path / "agc.npz"
    save_state(path, Agc.create(device=DEV))
    for template in (Eqlms.create(h_len=7, device=DEV), Agc.create(batch_shape=(2,), device=DEV),
                     FirFilter.create(_H9, dtype=torch.complex64, device=DEV)):
        with pytest.raises(ValueError):
            load_state(path, template)
    fpath = tmp_path / "fir.npz"
    save_state(fpath, FirFilter.create(_H9, dtype=torch.complex64, device=DEV))
    with pytest.raises(ValueError):
        load_state(fpath, FirFilter.create(_H9, dtype=torch.float32, device=DEV))
    np.savez(tmp_path / "other.npz", a=np.zeros(3))
    with pytest.raises(ValueError):
        load_state(tmp_path / "other.npz", Agc.create(device=DEV))


def test_checkpoint_dict_of_states(tmp_path):
    """A whole receiver graph (a dict of states, in sorted key order, with
    a tuple and a None inside) checkpoints as one file and restores leaf
    for leaf."""
    def graph():
        return {"sync": Symsync.create_rnyquist(FirFilterShape.RRCOS, 2, 7, 0.3,
                                                device=DEV).set_lf_bw(0.02),
                "agc": Agc.create(device=DEV), "dem": Freqdem.create(0.1, device=DEV),
                "pair": (Freqmod.create(0.1, device=DEV), None)}

    g = graph()
    _, g["agc"] = g["agc"].execute_block(_cx(256, seed=1))
    path = tmp_path / "graph.npz"
    save_state(path, g)
    restored = load_state(path, graph())
    assert list(restored) == list(g) and restored["pair"][1] is None
    for a, b in zip(state_leaves(g), state_leaves(restored)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(restored["agc"].g, g["agc"].g)


@struct.state
class _Counter:
    """A state with Python-number fields beside a tensor."""

    k: int = struct.static_field()
    count: int = struct.field()
    level: float = struct.field()
    flag: bool = struct.field()
    acc: torch.Tensor = struct.field()


def test_checkpoint_python_number_fields(tmp_path):
    """A non-static field holding a Python number comes back as the same
    Python type and value."""
    s = _Counter(k=3, count=17, level=0.25, flag=True, acc=torch.arange(4.0))
    save_state(tmp_path / "c.npz", s)
    r = load_state(tmp_path / "c.npz", _Counter(k=3, count=0, level=0.0, flag=False,
                                                acc=torch.zeros(4)))
    assert (type(r.count), type(r.level), type(r.flag)) == (int, float, bool)
    assert (r.count, r.level, r.flag, r.k) == (17, 0.25, True, 3)
    assert torch.equal(r.acc, s.acc)


def _cvsd_step(s, x):
    b, s = s.encode(x.real)
    return (b,), s


# the port's other stateful objects on the slice's paths: the codec, the
# waterfall (its row counters are host ints), and the fused receive chain
# and channelizer on their plain versions (on the card, chip_smoke.py's
# [frames] holds them through K1 and K2)
MORE = {
    "cvsd": (lambda: Cvsd.create(batch_shape=(2,), device=DEV), _cvsd_step,
             lambda n, seed=0: torch.stack([_cx(n, seed), _cx(n, seed + 1)]) * 0.3),
    "spwaterfall": (lambda: Spwaterfall.create(32, time_rows=4, device=DEV),
                    lambda s, x: ((), s.write(x)), _cx),
    "fused_rx_chain": (lambda: make_fused(2, DEV), lambda s, x: _outs(*s.step(x)),
                       lambda n, seed=0: torch.stack([_cx(n, seed), _cx(n, seed + 1)])),
    "fused_channelizer": (lambda: make_channelizer(DEV, r2=1),
                          lambda s, x: _outs(*s.analyzer_execute(x)),
                          lambda n, seed=0: _cx(2 * 64 * 128, seed)),
}


@pytest.mark.parametrize("name", sorted(MORE))
def test_checkpoint_roundtrip_more_types(tmp_path, name):
    """The round trip of test_checkpoint_roundtrip on the port's Cvsd,
    Spwaterfall, FusedRxChain and FusedChannelizer (CPU, plain versions)."""
    factory, step, gen = MORE[name]
    x = gen(1280, seed=7)
    b1, b2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    _, s = step(factory(), b1)
    ref_out, ref_state = step(s, b2)
    _, s2 = step(factory(), b1)
    save_state(tmp_path / "s.npz", s2)
    got_out, got_state = step(load_state(tmp_path / "s.npz", factory()), b2)
    for a, b in zip(ref_out, got_out):
        assert _equal(a, b)
    assert len(state_leaves(ref_state)) == len(state_leaves(got_state))
    for a, b in zip(state_leaves(ref_state), state_leaves(got_state)):
        np.testing.assert_array_equal(a, b)
