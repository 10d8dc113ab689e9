"""The FIR block kernel (``csrc/fir.cu``, ``fir_block_apply``) on the card
against its plain version, ``fir_block_reference`` (the banded matmul of
``filter/_conv.py``), run on the same CUDA tensors: y within 1e-5 of the
plain output's largest magnitude (the same L-tap float32 sums in another
order; TF32 off).

Cases: the four signal × tap pairs of float32 and complex64 at L 1, 2, 31,
129 and 1024 and n 0, 1, L − 1, L and 16,384, batch (3,); batch () and
(512,) at config[2]'s L 129 and n 16,384; a block whose data starts at an
odd element and whose rows are an odd length (no 16-byte loads or stores);
a 1,000 + 1,048 split of a 2,048-sample block through ``FirFilter``, bit
for bit against the whole block; the window ``FirFilter`` carries against
``carry`` at every n up to L + 2; ``FirFilter.execute_block`` captured in a
CUDA graph and replayed; the dtypes the kernel refuses. Each launch is
counted in ``fir_block_apply.launches``.

Marked ``card``: without a CUDA device they skip. On the card::

    python -m pytest --noconftest tests/test_torch_fir_card.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's runs
leave out; the unregistered marker then only warns.)
"""

import numpy as np
import pytest
import torch

from yagi_tpu_torch._src.window import carry
from yagi_tpu_torch.filter import FirFilter
from yagi_tpu_torch.kernels.fir import fir_block_apply, fir_block_reference

pytestmark = pytest.mark.card

Y_TOL = 1e-5  # of the plain output's largest magnitude
F32, C64 = torch.float32, torch.complex64
PAIRS = [(F32, F32), (F32, C64), (C64, F32), (C64, C64)]
PAIR_IDS = ["rr", "rc", "cr", "cc"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("the FIR block kernel is a CUDA kernel: it runs only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(rng, shape, dtype, dev):
    a = rng.standard_normal(shape)
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a).to(dtype).to(dev)


def _case(rng, batch, n, L, xt, ht, dev):
    x = _rand(rng, batch + (n,), xt, dev)
    window = _rand(rng, batch + (L,), xt, dev)
    h = _rand(rng, (L,), ht, dev)
    scale = torch.tensor(0.7 + 0.2j if ht.is_complex else 0.7, dtype=ht, device=dev)
    return x, window, h, scale


def _held(x, window, h, scale):
    """The kernel's y against the plain version's; one launch where n ≥ 1."""
    before = fir_block_apply.launches
    y = fir_block_apply(x, window, h, scale)
    torch.cuda.synchronize()
    want = fir_block_reference(x, window, h, scale)
    assert y.shape == want.shape and y.dtype == want.dtype and y.device == x.device
    assert fir_block_apply.launches - before == (1 if y.numel() else 0)
    if y.numel():
        assert bool(torch.isfinite(y).all())
        err = (y - want).abs().max().item()
        assert err <= Y_TOL * want.abs().max().item(), err
    return y


@pytest.mark.parametrize("xt, ht", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("L", [1, 2, 31, 129, 1024])
def test_kernel_matches_plain(dev, xt, ht, L):
    rng = np.random.default_rng(L)
    for n in sorted({0, 1, L - 1, L, 16384}):
        _held(*_case(rng, (3,), n, L, xt, ht, dev))


@pytest.mark.parametrize("xt, ht", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("batch", [(), (512,)], ids=["scalar", "config2"])
def test_batch_shapes(dev, xt, ht, batch):
    _held(*_case(np.random.default_rng(7), batch, 16384, 129, xt, ht, dev))


@pytest.mark.parametrize("xt, ht", PAIRS, ids=PAIR_IDS)
def test_odd_start_and_rows(dev, xt, ht):
    """x's data starts one element past a 16-byte boundary and its rows are
    16,383 samples: the kernel's 4- and 8-byte paths."""
    rng = np.random.default_rng(11)
    _, window, h, scale = _case(rng, (5,), 0, 129, xt, ht, dev)
    n = 16383
    buf = _rand(rng, (5 * n + 1,), xt, dev)
    x = buf[1:].view(5, n)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _held(x, window, h, scale)


@pytest.mark.parametrize("xt, ht", PAIRS, ids=PAIR_IDS)
def test_split_is_bit_identical(dev, xt, ht):
    """One 2,048-sample block equals its 1,000 + 1,048 split bit for bit:
    every output sums its taps in one order wherever its block starts."""
    rng = np.random.default_rng(3)
    x, _, h, _ = _case(rng, (4,), 2048, 129, xt, ht, dev)
    f = FirFilter.create(h.cpu().numpy(), scale=0.7, batch_shape=(4,), dtype=xt, device=dev)
    f = f.replace(window=_rand(rng, (4, 129), xt, dev))
    y, whole = f.execute_block(x)
    y1, f1 = f.execute_block(x[:, :1000])
    y2, f2 = f1.execute_block(x[:, 1000:])
    assert torch.equal(torch.cat([y1, y2], -1), y)
    assert torch.equal(f2.window, whole.window)


@pytest.mark.parametrize("xt", [F32, C64], ids=["real", "complex"])
def test_carried_window_is_carry(dev, xt):
    """The window ``FirFilter`` builds without xa equals carry(window, xa)
    in values and dtype at every n, the empty block included."""
    rng = np.random.default_rng(5)
    L = 31
    f = FirFilter.create(np.ones(L, np.float32), batch_shape=(3,), dtype=xt, device=dev)
    f = f.replace(window=_rand(rng, (3, L), xt, dev))
    for n in range(L + 3):
        x = _rand(rng, (3, n), xt, dev)
        _, g = f.execute_block(x)
        want = carry(f.window, torch.cat([f.window[..., 1:].to(x.dtype), x], -1))
        assert g.window.dtype == want.dtype and torch.equal(g.window, want), n


def test_graph_replay(dev):
    """``FirFilter.execute_block`` captured in a CUDA graph and replayed on a
    new block gives the eager call's bits."""
    rng = np.random.default_rng(9)
    x, _, h, _ = _case(rng, (64,), 4096, 129, C64, F32, dev)
    f = FirFilter.create(h.cpu().numpy(), batch_shape=(64,), dtype=C64, device=dev)
    f = f.replace(window=_rand(rng, (64, 129), C64, dev))
    static = x.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        f.execute_block(static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, g_g = f.execute_block(static)
    fresh = _rand(rng, (64, 4096), C64, dev)
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    y, g = f.execute_block(fresh)
    assert torch.equal(y_g, y) and torch.equal(g_g.window, g.window)


@pytest.mark.parametrize("xt, ht", [(torch.float64, F32), (F32, torch.float64),
                                    (torch.complex128, C64), (torch.float16, F32)])
def test_other_dtypes_raise(dev, xt, ht):
    x = torch.zeros((2, 8), dtype=xt, device=dev)
    with pytest.raises(TypeError):
        fir_block_apply(x, torch.zeros((2, 3), dtype=xt, device=dev),
                        torch.ones(3, dtype=ht, device=dev), torch.tensor(1.0, dtype=ht, device=dev))
