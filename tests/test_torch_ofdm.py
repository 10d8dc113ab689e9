"""The OFDM frame generator and synchronizer of yagi_tpu_torch against
yagi_tpu (multichannel/ofdm.py).

yagi_tpu runs them on the host in numpy complex128, the port in torch
complex128; both round to complex64 at the end. Tolerances:

* the subcarrier map, the sync symbols and pilots: exactly (the same numpy
  draws);
* generated frames (complex64): within 1e-9 (two FFT libraries in float64,
  rounded to the same float32 values here);
* synchronized data symbols: within 1e-9, the timing offset tau exactly,
  the CFO, RSSI, pilot EVM and the S1 correlation within 1e-9 relative;
* a frame not found is None in both.

One case departs from yagi_tpu on purpose: the port fits each symbol's
pilot phase line about the pilots' circular mean
(test_pilot_fit_at_pi_repaired), where yagi_tpu fits their raw angles and
loses a symbol whose common phase sits at ±π; elsewhere the symbols agree
within 1e-9.
"""

import numpy as np
import pytest
import torch

from yagi_tpu.multichannel import ofdm as jofdm
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.multichannel import ofdm as tofdm

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
TOL = 1e-9


def _qpsk(rng, shape):
    return ((1 - 2 * rng.integers(0, 2, shape))
            + 1j * (1 - 2 * rng.integers(0, 2, shape))) / np.sqrt(2)


@pytest.mark.parametrize("M,cp", [(64, 16), (128, 32), (32, 0)])
def test_geometry_and_generator_match(M, cp):
    np.testing.assert_array_equal(tofdm.default_sctype(M), jofdm.default_sctype(M))
    jg, tg = jofdm.OfdmFrameGen(M, cp), tofdm.OfdmFrameGen(M, cp, device=DEV)
    np.testing.assert_array_equal(tg.p, jg.p)
    np.testing.assert_array_equal(tg.S0f.numpy(), jg.S0f)
    np.testing.assert_array_equal(tg.S1f.numpy(), jg.S1f)
    np.testing.assert_array_equal(tg.pilots.numpy(), jg.pilots)
    assert (tg.n_data, tg.sym_len) == (jg.n_data, jg.sym_len)
    syms = _qpsk(np.random.default_rng(M), (5, jg.n_data))
    got = tg.assemble(syms)
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), jg.assemble(syms), rtol=0, atol=TOL)


def _impaired(seed: int, cfo: float, ns: int, noise: float, lead: int = 97):
    rng = np.random.default_rng(seed)
    gen = jofdm.OfdmFrameGen(64, 16)
    syms = _qpsk(rng, (ns, gen.n_data))
    frame = gen.assemble(syms)
    x = np.concatenate([np.zeros(lead), frame, np.zeros(250)])
    x = np.convolve(x, [1.0, 0.25j, -0.08])[: x.size] * np.exp(1j * (cfo * np.arange(x.size) + 0.4))
    x = x + noise * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return x.astype(np.complex64), syms


@pytest.mark.parametrize("cfo,noise", [(0.0, 0.0), (0.004, 0.02), (-0.006, 0.05)])
def test_sync_matches(cfo, noise):
    x, syms = _impaired(1, cfo, 12, noise)
    want = jofdm.OfdmFrameSync(64, 16).execute(x, 12)
    got = tofdm.OfdmFrameSync(64, 16, device=DEV).execute(torch.from_numpy(x), 12)
    assert want is not None and got is not None
    assert got["symbols"].dtype == torch.complex64
    np.testing.assert_allclose(got["symbols"].numpy(), want["symbols"], rtol=0, atol=TOL)
    assert got["stats"]["tau"] == want["stats"]["tau"]
    for k in ("cfo", "rssi_db", "evm_pilots_db", "rxy"):
        assert got["stats"][k] == pytest.approx(want["stats"][k], rel=TOL, abs=1e-12), k
    # and the link itself works: the symbols come back
    assert np.mean(np.abs(got["symbols"].numpy() - syms) ** 2) < 0.05


def test_no_frame_and_short_buffer():
    rng = np.random.default_rng(2)
    x = (0.01 * (rng.standard_normal(2000) + 1j * rng.standard_normal(2000))).astype(np.complex64)
    assert jofdm.OfdmFrameSync(64, 16).execute(x, 4) is None
    assert tofdm.OfdmFrameSync(64, 16, device=DEV).execute(torch.from_numpy(x), 4) is None
    x, _ = _impaired(3, 0.0, 6, 0.0, lead=10)
    # the frame's payload runs past the buffer's end: None in both
    cut = x[: 9 * 80]  # as long as a frame, but the frame starts 10 samples in
    assert jofdm.OfdmFrameSync(64, 16).execute(cut, 6) is None
    assert tofdm.OfdmFrameSync(64, 16, device=DEV).execute(torch.from_numpy(cut), 6) is None
    with pytest.raises(ConfigError):
        tofdm.OfdmFrameSync(64, 16, device=DEV).execute(torch.from_numpy(x[:100]), 6)


def test_rejects():
    with pytest.raises(ConfigError):
        tofdm.OfdmFrameGen(4, 2, device=DEV)
    with pytest.raises(ConfigError):
        tofdm.OfdmFrameGen(64, 128, device=DEV)
    with pytest.raises(ConfigError):
        tofdm.OfdmFrameGen(64, 16, sctype=np.zeros(64, np.int32), device=DEV)
    with pytest.raises(ConfigError):
        tofdm.OfdmFrameSync(64, 16, threshold=1.5, device=DEV)
    with pytest.raises(ConfigError):
        tofdm.OfdmFrameGen(64, 16, device=DEV).write_symbols(np.zeros((2, 3)))


def test_pilot_fit_at_pi_repaired():
    """Shared fault, repaired in the port (ROADMAP queue 3): M 64, cp 16,
    256 QPSK symbols at lead 137 through taps (1, 0.1j, −0.05), CFO 0.004
    and 30 dB, np.random.default_rng(0). The residual CFO's drift carries
    some symbols' common phase to ±π: yagi_tpu's fit over the raw pilot
    angles loses 7 of them (EVM above −20 dB); the port's fit about the
    circular mean loses none, and every symbol yagi_tpu keeps is equal
    within TOL."""
    rng = np.random.default_rng(0)
    gen = jofdm.OfdmFrameGen(64, 16)
    data = _qpsk(rng, (256, gen.n_data))
    buf = np.concatenate([np.zeros(137), gen.assemble(data), np.zeros(300)])
    buf = np.convolve(buf, [1.0, 0.1j, -0.05])[: buf.size] * np.exp(
        1j * (0.004 * np.arange(buf.size) + 0.3))
    nstd = 10 ** (-30 / 20) / np.sqrt(2)
    buf = (buf + nstd * (rng.standard_normal(buf.size) + 1j * rng.standard_normal(buf.size))
           ).astype(np.complex64)
    want = jofdm.OfdmFrameSync(64, 16).execute(buf, 256)
    got = tofdm.OfdmFrameSync(64, 16, device=DEV).execute(torch.from_numpy(buf), 256)

    def evm(s):
        return 10 * np.log10(np.mean(np.abs(np.asarray(s) - data) ** 2, 1))

    lost_j, lost_t = evm(want["symbols"]) > -20, evm(got["symbols"].numpy()) > -20
    assert lost_j.sum() == 7 and lost_t.sum() == 0
    np.testing.assert_allclose(got["symbols"].numpy()[~lost_j], want["symbols"][~lost_j],
                               rtol=0, atol=TOL)
    assert got["stats"]["tau"] == want["stats"]["tau"] == 137
    assert got["stats"]["cfo"] == pytest.approx(want["stats"]["cfo"], rel=TOL)
