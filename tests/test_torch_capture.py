"""The port's native capture-file loader on the CPU.

yagi_tpu_torch.native.IqStreamLoader against yagi_tpu's loader on the same
files (cf32, ci16, cu8; 7,000 samples in blocks of 2048, so the last block
is a tail), bit for bit; a 4-block ci16 capture at M = 64, T = 2^10 through
Firpfbch → Freqdem (and FusedChannelizer's plain route) equal, outputs and
carried state, to the same samples fed from memory; the library the port
loads lies under build/ and native/libyagi_native.so keeps its bytes when
the port builds.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from yagi_tpu.native import IqStreamLoader as JLoader
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.modem import Freqdem
from yagi_tpu_torch.multichannel import Firpfbch, FusedChannelizer
from yagi_tpu_torch.native import (
    IqStreamLoader,
    build,
    library_path,
    load_native,
    native_available,
)

torch.set_num_threads(1)

DEV = "cpu"  # the loader's blocks and the chain live on the CPU

_ROOT = Path(__file__).resolve().parent.parent
M, T, N_BLOCKS = 64, 1 << 10, 4


@pytest.fixture
def native():
    if not native_available():
        pytest.skip("no C++ compiler to build native/*.cpp")


def write_capture(path: Path, fmt: str, re: np.ndarray, im: np.ndarray):
    """Interleave and quantize (re, im) as tests/test_native_kernels.py:113-140
    does; returns the planes the file holds, dequantized."""
    inter = np.empty(2 * re.size, np.float32)
    inter[0::2], inter[1::2] = re, im
    if fmt == "cf32":
        path.write_bytes(inter.tobytes())
        return inter[0::2], inter[1::2]
    if fmt == "ci16":
        q = np.clip(np.round(inter * 32768), -32768, 32767).astype(np.int16)
        path.write_bytes(q.tobytes())
        return q[0::2].astype(np.float32) / 32768, q[1::2].astype(np.float32) / 32768
    q = np.clip(np.round(inter * 128) + 128, 0, 255).astype(np.uint8)
    path.write_bytes(q.tobytes())
    return (q[0::2].astype(np.float32) - 128) / 128, (q[1::2].astype(np.float32) - 128) / 128


@pytest.mark.parametrize("fmt", ["cf32", "ci16", "cu8"])
def test_roundtrip_matches_yagi_tpu(native, fmt, tmp_path):
    rng = np.random.default_rng(3)
    n = 7000  # not a multiple of the block (the EOF tail)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.5
    path = tmp_path / f"capture.{fmt}"
    want_re, want_im = write_capture(path, fmt, x.real.astype(np.float32),
                                     x.imag.astype(np.float32))
    with IqStreamLoader(path, fmt, block_samples=2048, device=DEV) as src:
        got = list(src)
        assert src.total_read() == n
        assert src.next_block() == (None, None)
    with JLoader(path, fmt, block_samples=2048) as jsrc:
        ref = list(jsrc)
    assert [b[0].shape[0] for b in got] == [r[0].shape[0] for r in ref] == [2048] * 3 + [856]
    for (re, im), (jre, jim) in zip(got, ref):
        assert re.dtype == im.dtype == torch.float32 and re.device.type == DEV
        np.testing.assert_array_equal(re.numpy(), jre)
        np.testing.assert_array_equal(im.numpy(), jim)
    np.testing.assert_array_equal(torch.cat([b[0] for b in got]).numpy(), want_re)
    np.testing.assert_array_equal(torch.cat([b[1] for b in got]).numpy(), want_im)


def _chain(kind):
    if kind == "firpfbch":
        chz = Firpfbch.create_kaiser(M, 4, 60.0, device=DEV)

        def step(c, re, im):
            y, c = c.analyzer_execute(torch.complex(re, im))
            return y, c
    else:
        chz = FusedChannelizer.create_kaiser(M, 4, 60.0, device=DEV)

        def step(c, re, im):
            yr, yi, c = c.analyzer_execute_planar(re, im)
            return torch.complex(yr, yi).T, c
    return chz, step, Freqdem.create(0.1, batch_shape=(M,), device=DEV)


def _run(kind, blocks):
    chz, step, dem = _chain(kind)
    outs = []
    for re, im in blocks:
        y, chz = step(chz, re, im)
        fm, dem = dem.demodulate(y)
        outs.append((y, fm))
    return outs, chz, dem


@pytest.mark.parametrize("kind", ["firpfbch", "fused"])
def test_capture_through_the_channelizer(native, kind, tmp_path):
    rng = np.random.default_rng(1)
    n = M * T
    x = rng.standard_normal((2, N_BLOCKS * n)).astype(np.float32) / 8  # full scale at 8σ
    path = tmp_path / "capture.ci16"
    re, im = write_capture(path, "ci16", x[0], x[1])
    mem = [(torch.from_numpy(re[k * n : (k + 1) * n]), torch.from_numpy(im[k * n : (k + 1) * n]))
           for k in range(N_BLOCKS)]
    with IqStreamLoader(path, "ci16", block_samples=n, device=DEV) as src:
        from_file = list(src)
        assert src.total_read() == N_BLOCKS * n
    assert len(from_file) == N_BLOCKS
    for (a, b), (c, d) in zip(from_file, mem):
        assert torch.equal(a, c) and torch.equal(b, d)
    got, chz_f, dem_f = _run(kind, from_file)
    want, chz_m, dem_m = _run(kind, mem)
    for (y, fm), (y_m, fm_m) in zip(got, want):
        assert y.shape == fm.shape == (M, T)
        assert torch.equal(y, y_m) and torch.equal(fm, fm_m)
    for a, b in ((chz_f, chz_m), (dem_f, dem_m)):
        for f in a.__dataclass_fields__:
            va, vb = getattr(a, f), getattr(b, f)
            assert torch.equal(va, vb) if isinstance(va, torch.Tensor) else va == vb, f


def test_library_under_build_and_committed_so_untouched(native, tmp_path):
    committed = _ROOT / "native" / "libyagi_native.so"
    before = hashlib.sha256(committed.read_bytes()).hexdigest()
    lib = load_native()
    path = Path(lib._name).resolve()
    assert path == library_path().resolve()
    assert path.parent == (_ROOT / "build" / "yagi_tpu_torch").resolve()
    fresh = build(tmp_path)  # a fresh build, as at first use in a new checkout
    assert fresh.parent == tmp_path and fresh.name == path.name and fresh.stat().st_size > 0
    assert not list(tmp_path.glob("*.tmp"))
    assert hashlib.sha256(committed.read_bytes()).hexdigest() == before


def test_loader_errors(native, tmp_path, monkeypatch):
    path = tmp_path / "c.cf32"
    path.write_bytes(np.zeros(16, np.float32).tobytes())
    with pytest.raises(ConfigError):
        IqStreamLoader(path, "cs8", device=DEV)
    with pytest.raises(OSError):
        IqStreamLoader(tmp_path / "missing.cf32", device=DEV)
    with pytest.raises(OSError):
        IqStreamLoader(path, block_samples=0, device=DEV)
    with IqStreamLoader(path, n_buffers=2, device=DEV) as src:
        re, im = src.next_block()
        assert re.shape == (8,) and not re.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        IqStreamLoader(path)
