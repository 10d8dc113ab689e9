"""``kernels/fir.py`` on the CPU: the FIR block wrapper's routes and the
arguments it refuses, its plain version equal to the banded matmul
``causal_conv_valid(cat(window[..., 1:], x), h) · scale`` bit for bit, the
window ``FirFilter`` carries (built without that concatenation) equal to
``carry`` at every n, the kernel route's ``conv.*`` counts against their
formulas with the launch stubbed, and the layout that ``smem_bytes``
mirrors from ``csrc/fir.cu``. The kernel itself runs in
``tests/test_torch_fir_card.py``."""

import re

import numpy as np
import pytest
import torch

from yagi_tpu_torch import trace
from yagi_tpu_torch._src.window import carry
from yagi_tpu_torch.filter import FirFilter
from yagi_tpu_torch.filter._conv import causal_conv_valid
from yagi_tpu_torch.kernels import _build, fir
from yagi_tpu_torch.kernels.fir import fir_block_apply, fir_block_reference

torch.set_num_threads(1)

DEV = "cpu"
F32, C64 = torch.float32, torch.complex64
PAIRS = [(F32, F32), (F32, C64), (C64, F32), (C64, C64)]
PAIR_IDS = ["rr", "rc", "cr", "cc"]


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a).to(dtype)


def _case(rng, batch, n, L, xt, ht):
    scale = torch.tensor(0.7 + 0.2j if ht.is_complex else 0.7, dtype=ht)
    return (_rand(rng, batch + (n,), xt), _rand(rng, batch + (L,), xt), _rand(rng, (L,), ht),
            scale)


@pytest.fixture
def card_route(monkeypatch):
    """The kernel route on CPU tensors, its launch replaced by a stand-in
    that records its arguments."""
    calls = []
    monkeypatch.setattr(fir, "route", lambda device, fn: "cuda")
    monkeypatch.setattr(_build, "launch", lambda kernel, device, entry, *args: calls.append(
        (kernel, entry, args)))
    trace.reset()
    return calls


@pytest.mark.parametrize("xt, ht", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("L, n", [(1, 0), (1, 5), (2, 1), (31, 30), (31, 31), (129, 300),
                                  (129, 0)])
def test_plain_version_is_the_banded_matmul(xt, ht, L, n):
    """Bit for bit what ``FirFilter.execute_block`` computed before the
    kernel: the banded matmul over the concatenated block, then the scale."""
    rng = np.random.default_rng(L * 1000 + n)
    x, window, h, scale = _case(rng, (3,), n, L, xt, ht)
    want = causal_conv_valid(torch.cat([window[..., 1:].to(x.dtype), x], -1), h) * scale
    for got in (fir_block_reference(x, window, h, scale), fir_block_apply(x, window, h, scale)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, window, h, scale = _case(np.random.default_rng(1), (2,), 64, 9, C64, F32)
    before = fir_block_apply.launches
    fir_block_apply(x, window, h, scale)
    assert fir_block_apply.launches == before


def test_a_device_with_no_implementation_raises():
    x, window, h, scale = (t.to("meta") for t in _case(np.random.default_rng(1), (2,), 8, 3,
                                                         F32, F32))
    with pytest.raises(ValueError, match="no implementation"):
        fir_block_apply(x, window, h, scale)


@pytest.mark.parametrize("what", ["x_0d", "h_2d", "h_empty", "window_shape", "window_batch",
                                  "scale_shape", "scale_not_tensor", "window_device"])
def test_bad_arguments_raise_on_either_route(what):
    x, window, h, scale = _case(np.random.default_rng(2), (2,), 16, 5, F32, F32)
    args = {
        "x_0d": (x[0, 0], window, h, scale),
        "h_2d": (x, window, h[None], scale),
        "h_empty": (x, window[..., :0], h[:0], scale),
        "window_shape": (x, window[..., :4], h, scale),
        "window_batch": (x, window[:1], h, scale),
        "scale_shape": (x, window, h, scale[None]),
        "scale_not_tensor": (x, window, h, 0.5),
        "window_device": (x, window.to("meta"), h, scale),
    }[what]
    with pytest.raises((ValueError, TypeError)):
        fir_block_apply(*args)


@pytest.mark.parametrize("xt, ht", [(torch.float64, F32), (F32, torch.float64),
                                    (torch.complex128, C64), (torch.float16, F32)])
def test_the_kernel_route_refuses_other_dtypes(card_route, xt, ht):
    x = torch.zeros((2, 8), dtype=xt)
    with pytest.raises(TypeError, match="float32 or complex64"):
        fir_block_apply(x, torch.zeros((2, 3), dtype=xt), torch.ones(3, dtype=ht),
                        torch.tensor(1.0, dtype=ht))
    assert not card_route


def test_the_kernel_route_wants_the_scale_in_the_taps_type(card_route):
    with pytest.raises(TypeError):
        fir_block_apply(torch.zeros((2, 8)), torch.zeros((2, 3)), torch.ones(3),
                        torch.tensor(1.0 + 0j, dtype=C64))


def test_the_kernel_route_refuses_taps_past_shared_memory(card_route):
    L = 8133  # complex signal and taps: past 232,448 bytes (fir.cu's layout)
    assert fir.smem_bytes(L - 1, True, True) <= fir.SMEM_LIMIT < fir.smem_bytes(L, True, True)
    with pytest.raises(ValueError, match="past the card"):
        fir_block_apply(torch.zeros((1, 4), dtype=C64), torch.zeros((1, L), dtype=C64),
                        torch.ones(L, dtype=C64), torch.tensor(1.0 + 0j, dtype=C64))
    assert not card_route


@pytest.mark.parametrize("xt, ht", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("batch, n", [((3,), 100), ((), 7), ((2, 5), 1), ((4,), 0)])
def test_kernel_route_counts(card_route, xt, ht, batch, n):
    """The kernel writes no frames and runs only its taps' multiply-adds:
    ``conv.frame_bytes`` += 0, ``conv.macs`` = ``conv.tap_macs`` += B·n·L·r
    (r = 1, 2, 2, 4); one launch where the block has samples, with the
    instance's arguments."""
    L = 129
    x, window, h, scale = _case(np.random.default_rng(4), batch, n, L, xt, ht)
    before = fir_block_apply.launches
    y = fir_block_apply(x, window, h, scale)
    B = int(np.prod(batch))
    r = {(F32, F32): 1, (F32, C64): 2, (C64, F32): 2, (C64, C64): 4}[(xt, ht)]
    assert fir.real_macs(xt, ht) == r
    counters = trace.snapshot()["counters"]
    assert counters["conv.frame_bytes"] == 0
    assert counters["conv.macs"] == counters["conv.tap_macs"] == B * n * L * r
    assert y.shape == batch + (n,) and y.dtype == torch.promote_types(xt, ht)
    launched = B * n > 0
    assert fir_block_apply.launches - before == int(launched) and len(card_route) == int(launched)
    if launched:
        kernel, entry, args = card_route[0]
        assert kernel is fir_block_apply and entry == "yagi_fir_block"
        assert args[5:] == (B, n, L, int(xt.is_complex), int(ht.is_complex))
        assert args[4] == y.data_ptr()


def test_a_filter_step_on_the_kernel_route_counts_its_filters(card_route):
    """``FmStereoRx.step``'s four FIRs on the kernel route: no frames, the
    taps' multiply-adds alone (the pilot's real composite through complex
    taps, the delay's and the sum's real, the difference's complex × real),
    four launches."""
    from yagi_tpu_torch.chains import FmStereoRx

    C, T, L = 2, 256, 129
    rx = FmStereoRx.create(batch_shape=(C,), device=DEV)
    iq = _rand(np.random.default_rng(6), (C, T), C64)
    before = fir_block_apply.launches
    rx.step(iq)
    counters = trace.snapshot()["counters"]
    assert counters["conv.frame_bytes"] == 0
    assert counters["conv.macs"] == counters["conv.tap_macs"] == C * T * L * (2 + 1 + 1 + 2)
    assert fir_block_apply.launches - before == 4
    assert [entry for _, entry, _ in card_route] == ["yagi_fir_block"] * 4


@pytest.mark.parametrize("xt, wt", [(F32, F32), (C64, C64), (F32, C64), (C64, F32)])
@pytest.mark.parametrize("L", [1, 2, 9])
def test_the_carried_window_is_carry(xt, wt, L):
    """``FirFilter``'s new window, built without xa, equals carry(window,
    xa) in values and dtype at every n, the empty block included, and holds
    no view of the caller's block."""
    rng = np.random.default_rng(L)
    f = FirFilter.create(np.ones(L, np.float32), batch_shape=(3,), dtype=wt, device=DEV)
    f = f.replace(window=_rand(rng, (3, L), wt))
    for n in range(L + 3):
        x = _rand(rng, (3, n), xt)
        _, g = f.execute_block(x)
        xa = torch.cat([f.window[..., 1:].to(x.dtype), x], -1)
        want = carry(f.window, xa)
        assert g.window.dtype == want.dtype and torch.equal(g.window, want), n
        assert g.window.is_contiguous()
        if n:
            assert g.window.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


def test_smem_bytes_mirrors_fir_cu():
    """The kernel's constants as ``fir.cu`` has them, and its layout at
    config[2]'s 129 taps: two staged tiles of 1680 samples a plane, 1536
    outputs a plane, 156 taps a plane."""
    src = (_build._CSRC / "fir.cu").read_text()
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == fir.THREADS
    assert int(re.search(r"kR = (\d+);", src).group(1)) == fir.R
    assert int(re.search(r"kSmemLimit = (\d+);", src).group(1)) == fir.SMEM_LIMIT
    assert (fir.R // 4) % 2 == 1  # a thread's samples 3 bank groups on: no conflicts
    assert fir.smem_bytes(129, False, False) == (2 * 1680 + 1536 + 156) * 4
    assert fir.smem_bytes(129, True, False) == (4 * 1680 + 2 * 1536 + 156) * 4
    assert fir.smem_bytes(129, False, True) == (2 * 1680 + 2 * 1536 + 2 * 156) * 4
    assert fir.smem_bytes(129, True, True) == (4 * 1680 + 2 * 1536 + 2 * 156) * 4
