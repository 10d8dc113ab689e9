"""yagi_tpu_torch.fft (layer L2) and the rest of math/windows against yagi_tpu.

* fft_run / ifft_run against the reference's golden vectors
  (tests/golden/fft.npz, tolerance 2e-4 as tests/test_fft.py) and against
  yagi_tpu's transforms (two float32 FFT libraries: within 1e-5 of the
  output's peak); liquid's odd-length fft_shift; the Fft object;
* DCT/DST I–IV: the same float64 basis, a float32 product: within 1e-5 of
  the output's peak of yagi_tpu's;
* Spgram, Spwaterfall, Asgram, spgram_estimate_psd and the PSD validators
  against yagi_tpu on the same input: counters equal, PSDs within 1e-5 of
  their peak (the frames' FFTs and their sums in another order);
* the windows: the same float64 NumPy code, equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_util import load
from yagi_tpu import fft as jfft
from yagi_tpu.math import windows as jwin
from yagi_tpu.utils import psd_validate as jpsd
from yagi_tpu_torch import fft as tfft
from yagi_tpu_torch.errors import ConfigError, DeviceError, ValueRangeError
from yagi_tpu_torch.math import windows as twin
from yagi_tpu_torch.utils import (
    PsdRegion,
    validate_psd_signal,
    validate_psd_spectrum,
    validate_psd_spgram,
)

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
FFT_SIZES = [
    2, 3, 4, 5, 6, 7, 8, 9, 10, 16, 17, 20, 21, 22, 24, 26, 30, 32, 35, 36,
    43, 48, 63, 64, 79, 92, 96, 120, 130, 157, 192, 317, 509,
]
PSD_RTOL = 1e-5


def _cplx(rng, n) -> np.ndarray:
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _peak_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ----------------------------------------------------------------- fft_run
@pytest.fixture(scope="module")
def golden():
    return load("fft")


@pytest.mark.parametrize("n", FFT_SIZES)
def test_fft_golden(golden, n):
    x = torch.from_numpy(golden[f"FFT_TEST_X{n}"])
    y = tfft.fft_run(x)
    assert y.dtype == torch.complex64
    assert np.abs(y.numpy() - golden[f"FFT_TEST_Y{n}"]).max() < 2e-4
    z = tfft.fft_run(y, tfft.FFT_BACKWARD) / n  # liquid's unnormalized inverse
    assert np.abs(z.numpy() - golden[f"FFT_TEST_X{n}"]).max() < 2e-4


@pytest.mark.parametrize("n", [7, 64, 509, 1200])
def test_fft_matches_yagi_tpu(n):
    x = _cplx(np.random.default_rng(n), (3, n))
    assert _peak_err(tfft.fft_run(torch.from_numpy(x)).numpy(), jfft.fft_run(x)) < 1e-5
    assert _peak_err(tfft.ifft_run(torch.from_numpy(x)).numpy(), jfft.ifft_run(x)) < 1e-5


@pytest.mark.parametrize("n", [4, 5, 8, 9])
def test_fft_shift_matches_yagi_tpu(n):
    x = np.arange(n)
    np.testing.assert_array_equal(tfft.fft_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfft.fft_shift(x)))


def test_fft_shift_odd_liquid_convention():
    np.testing.assert_array_equal(tfft.fft_shift(torch.arange(5)).numpy(), [2, 3, 0, 1, 4])


def test_fft_object():
    f = tfft.Fft(16)
    x = _cplx(np.random.default_rng(0), 16)
    np.testing.assert_allclose(f.run(torch.from_numpy(x)).numpy(), np.fft.fft(x), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ConfigError):
        f.run(torch.zeros(8, dtype=torch.complex64))
    with pytest.raises(ConfigError):
        tfft.Fft(16, "sideways")
    with pytest.raises(ConfigError):
        tfft.Fft(0)
    with pytest.raises(ConfigError):
        tfft.fft_run(torch.zeros(4, dtype=torch.complex64), "sideways")


def test_host_input_goes_to_the_card_unless_asked(monkeypatch):
    """A numpy argument lands on the card by default (DeviceError with no
    card) or on the device named; a tensor stays where it is, float64
    taken as float32 as yagi_tpu's arrays are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(8.0)
    with pytest.raises(DeviceError):
        tfft.fft_run(x)
    with pytest.raises(DeviceError):
        tfft.Spgram.create(64)
    y = tfft.fft_run(x, device=DEV)
    assert y.device.type == "cpu" and y.dtype == torch.complex64
    assert tfft.dct(torch.from_numpy(x)).dtype == torch.float32


# --------------------------------------------------------------------- r2r
@pytest.mark.parametrize("kind", [1, 2, 3, 4])
@pytest.mark.parametrize("fam", ["dct", "dst"])
@pytest.mark.parametrize("n", [8, 27, 32])
def test_r2r_matches_yagi_tpu(fam, kind, n):
    x = np.random.default_rng(n * 8 + kind).standard_normal((2, n))
    got = getattr(tfft, fam)(torch.from_numpy(x), kind=kind)
    assert got.dtype == torch.float32 and got.shape == (2, n)
    assert _peak_err(got.numpy(), getattr(jfft, fam)(x, kind=kind)) < 1e-5


def test_r2r_inverse_pairs_and_errors():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(12).astype(np.float32))
    for fam, kind, pair in (("dct", 2, 3), ("dst", 1, 1), ("dct", 4, 4)):
        f = getattr(tfft, fam)
        y = f(f(x, kind=kind), kind=pair)
        torch.testing.assert_close(y, tfft.r2r_inverse_scale(f"{fam}{kind}", 12) * x,
                                   rtol=2e-4, atol=2e-3)
    with pytest.raises(ConfigError):
        tfft.dct(torch.zeros(8), kind=5)
    with pytest.raises(ConfigError):
        tfft.dst(torch.zeros(8), kind=0)
    with pytest.raises(ConfigError):
        tfft.dct(torch.zeros(1), kind=1)


# ----------------------------------------------------------------- windows
def _arg(wt):
    return {"kaiser": 7.0, "kbd": 3.0, "triangular": 40, "rcostaper": 10}.get(wt.value, 0.0)


@pytest.mark.parametrize("name", [w.value for w in jwin.WindowType if w.value != "unknown"])
def test_windows_match_yagi_tpu(name):
    jt, tt = jwin.get_window_type(name), twin.get_window_type(name)
    assert tt.value == jt.value
    np.testing.assert_array_equal(twin.window(tt, 40, _arg(tt)), jwin.window(jt, 40, _arg(jt)))
    assert twin.window_at(tt, 11, 40, _arg(tt)) == jwin.window_at(jt, 11, 40, _arg(jt))


def test_window_errors():
    with pytest.raises(ConfigError):
        twin.get_window_type("boxcar")
    with pytest.raises(ValueRangeError):
        twin.hann(0)
    with pytest.raises(ValueRangeError):
        twin.kbd_window(7, 3.0)
    with pytest.raises(ValueRangeError):
        twin.window_at(twin.WindowType.HANN, 40, 40)
    assert twin.kbd(3, 40, 3.0) == jwin.kbd(3, 40, 3.0)


# ------------------------------------------------------------------ Spgram
def _spgram_pair(nfft, window: str, *args):
    """yagi_tpu's Spgram and the port's, each with its own WindowType."""
    return (jfft.Spgram.create(nfft, jwin.get_window_type(window), *args),
            tfft.Spgram.create(nfft, twin.get_window_type(window), *args, device=DEV))


def _same_counters(j, t):
    for f in ("sample_timer", "num_samples", "num_samples_total", "num_transforms",
              "num_transforms_total"):
        assert getattr(t, f) == int(getattr(j, f)), f


@pytest.mark.parametrize("alpha", [-1.0, 0.1])
@pytest.mark.parametrize("wtype", ["hamming", "kaiser", "kbd"])
def test_spgram_streams_like_yagi_tpu(wtype, alpha):
    """Blocks of uneven length (one shorter than the delay, one a single
    sample): the same counters and PSD after every block."""
    rng = np.random.default_rng(7)
    j, t = _spgram_pair(128, wtype, 64, 24, alpha)
    np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w))
    for n in (500, 7, 1, 333, 24):
        x = _cplx(rng, n)
        j, t = j.write(jnp.asarray(x)), t.write(torch.from_numpy(x))
        _same_counters(j, t)
        assert _peak_err(t.psd.numpy(), j.psd) < PSD_RTOL
    assert _peak_err(t.get_psd_mag().numpy(), j.get_psd_mag()) < PSD_RTOL
    np.testing.assert_array_equal(t.buffer.numpy(), np.asarray(j.buffer))


def test_spgram_step_clear_reset_like_yagi_tpu():
    rng = np.random.default_rng(8)
    j, t = _spgram_pair(64, "hann", 48, 16, 0.2)
    x = _cplx(rng, 100)
    j, t = j.write(jnp.asarray(x)).step(), t.write(torch.from_numpy(x)).step()
    _same_counters(j, t)
    assert _peak_err(t.get_psd_mag().numpy(), j.get_psd_mag()) < PSD_RTOL
    j, t = j.clear(), t.clear()
    _same_counters(j, t)
    j, t = j.write(jnp.asarray(x[:40])), t.write(torch.from_numpy(x[:40]))
    assert _peak_err(t.psd.numpy(), j.psd) < PSD_RTOL
    j, t = j.reset(), t.reset()
    _same_counters(j, t)
    assert not bool(t.buffer.any())
    t2 = t.set_alpha(-1.0)
    assert t2.get_alpha() == -1.0 and t.set_alpha(0.3).get_alpha() == pytest.approx(0.3)


@pytest.mark.parametrize("n", [200, 24000])
def test_spgram_estimate_psd_matches_yagi_tpu(n):
    """200 samples fire no transform: the estimate forces one (step)."""
    x = (1.0 + 0.1 * _cplx(np.random.default_rng(n), n)).astype(np.complex64)
    got = 10.0 ** (tfft.spgram_estimate_psd(1200, torch.from_numpy(x)).numpy() / 10)
    want = 10.0 ** (np.asarray(jfft.spgram_estimate_psd(1200, x)) / 10)
    assert _peak_err(got, want) < PSD_RTOL


def test_spgram_invalid_configs():
    for args in [(0,), (1,), (2, twin.WindowType.HAMMING, 100, 100),
                 (400, twin.WindowType.HAMMING, 0, 200), (400, twin.WindowType.KBD, 201, 200),
                 (400, twin.WindowType.HAMMING, 200, 0),
                 (64, twin.WindowType.HAMMING, 32, 16, 2.0)]:
        with pytest.raises(ConfigError):
            tfft.Spgram.create(*args, device=DEV)
    with pytest.raises(ConfigError):
        tfft.Spgram.create(540, device=DEV).set_rate(-10e6)


def test_spgram_gnuplot_export(tmp_path):
    sp = tfft.Spgram.create(128, twin.WindowType.HAMMING, 64, 32, device=DEV)
    sp = sp.write(torch.from_numpy(_cplx(np.random.default_rng(3), 4096)))
    path = str(tmp_path / "psd.gnu")
    sp.export_gnuplot(path)
    data = [ln for ln in open(path).read().splitlines()
            if ln and not ln.startswith(("#", "set", "reset", "plot", "e"))]
    assert len(data) == 128 and float(data[0].split()[0]) == -0.5


def test_psd_validators_match_yagi_tpu():
    x = (np.sqrt(0.5) * _cplx(np.random.default_rng(11), 8192)).astype(np.complex64)
    sp = tfft.Spgram.create(512, device=DEV).write(torch.from_numpy(x))
    flat = [PsdRegion(-0.5, 0.5, pmin=-10.0, pmax=10.0, test_lo=True, test_hi=True)]
    tight = [PsdRegion(-0.5, 0.5, pmin=-0.01, pmax=0.01, test_lo=True, test_hi=True)]
    assert validate_psd_spgram(sp, flat) and not validate_psd_spgram(sp, tight)
    jregions = [jpsd.PsdRegion(-0.5, 0.5, -10.0, 10.0, True, True)]
    assert validate_psd_signal(x, flat) == jpsd.validate_psd_signal(x, jregions)
    with pytest.raises(ConfigError):
        validate_psd_spectrum(np.zeros(8), 8, [PsdRegion(0.4, 0.1)])


# ------------------------------------------------------ Spwaterfall, Asgram
@pytest.mark.parametrize("time_rows", [4, 64])
def test_spwaterfall_matches_yagi_tpu(time_rows):
    """time_rows = 4 folds the rows 2:1 on the way (twice)."""
    x = _cplx(np.random.default_rng(time_rows), 2400)
    j = jfft.Spwaterfall.create(128, time_rows=time_rows, transforms_per_row=4)
    t = tfft.Spwaterfall.create(128, time_rows=time_rows, transforms_per_row=4, device=DEV)
    for blk in np.split(x, [300, 301, 1500]):
        j, t = j.write(jnp.asarray(blk)), t.write(torch.from_numpy(blk))
    assert (t.num_rows, t.row_scale) == (int(j.num_rows), int(j.row_scale))
    assert t.row_scale == (4 if time_rows == 4 else 1)
    assert _peak_err(10 ** (t.get_psd().numpy() / 10), 10 ** (np.asarray(j.get_psd()) / 10)) < PSD_RTOL
    with pytest.raises(ConfigError):
        tfft.Spwaterfall.create(128, time_rows=1, device=DEV)


def test_asgram_matches_yagi_tpu():
    n = np.arange(4096)
    x = (np.exp(2j * np.pi * 0.1875 * n)
         + 0.01 * _cplx(np.random.default_rng(4), 4096)).astype(np.complex64)
    j, t = jfft.Asgram(64), tfft.Asgram(64, device=DEV)
    j.push(x)
    t.push(x)
    (lj, fj, pj), (lt, ft, pt) = j.execute(), t.execute()
    assert (lt, ft) == (lj, fj) and pt == pytest.approx(pj, abs=1e-3)
    with pytest.raises(ConfigError):
        tfft.Asgram(1, device=DEV)
    with pytest.raises(ConfigError):
        t.set_display(0.0, 0.0)
