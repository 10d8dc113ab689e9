"""The u32 PFB resampler's kernel (``csrc/resamp.cu``, ``resamp_u32_apply``) on
the card against its plain version, ``resamp_u32_reference``, run on the same
CUDA tensors: the count, the new phase and the new window exact (the window
is a copy: its bits), y within 1e-6 of the plain output's rms (the same
L-tap float32 sums in another order) and its bits 0 past the count.

Cases: config[1]'s shape (1024 × 4096, L 14, 256 branches, and 3976 outputs,
the capacity ``MsResamp`` gives); ``n_valid`` below n, 0 and n, as a device tensor and as
an int; a carried phase near 2^32; C = 5 (a row group of 32 mostly empty); an
interpolating rate (several outputs an input); m 3 and m 12 (L 6 and 24); 64
branches; 4096 branches, whose table is read through L1; a rate of 0.3,
whose outputs take several staged passes; and three blocks against one long
one, bit for bit. Each launch is counted in ``resamp_u32_apply.launches``.

Marked ``card``: without a CUDA device they skip. On the card::

    python -m pytest --noconftest tests/test_torch_resamp_card.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's runs
leave out; the unregistered marker then only warns.)
"""

import numpy as np
import pytest
import torch

from yagi_tpu_torch.filter import Resamp
from yagi_tpu_torch.kernels.resamp import resamp_u32_apply, resamp_u32_reference

pytestmark = pytest.mark.card

Y_TOL = 1e-6  # of the plain output's rms
RATE1 = 2.0 / 2.0663  # config[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("the resampler's kernel is a CUDA kernel: it runs only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits(t):
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _cx(rng, shape, dev):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


def _held(got, want):
    """The kernel's (y, count, phase, window) against the plain version's;
    returns the count and y's largest error over the rms."""
    (y, count, phase, window), (y_p, count_p, phase_p, window_p) = got, want
    c = int(count_p)
    assert int(count) == c and int(phase) == int(phase_p)
    assert count.dtype == phase.dtype == torch.int64 and count.dim() == phase.dim() == 0
    assert torch.equal(_bits(window), _bits(window_p))
    assert y.shape == y_p.shape and not _bits(y)[..., c:, :].any()
    if c == 0:
        return c, 0.0
    rms = float(y_p[..., :c].abs().square().mean().sqrt())
    err = float((y - y_p).abs().max()) / rms
    assert err <= Y_TOL, err
    return c, err


def _run(x, window, rs, phase, n_valid, cap):
    args = (x, window, rs.branches, phase, rs.step, n_valid)
    before = resamp_u32_apply.launches
    got = resamp_u32_apply(*args, out_capacity=cap)
    assert resamp_u32_apply.launches == before + 1
    return got, resamp_u32_reference(*args, out_capacity=cap)


# (id, rate, C, n, n_valid ("n" for all of it), m, npfb, phase, n_valid a tensor)
CASES = [
    ("config1", RATE1, 1024, 4096, "n", 7, 256, 0, False),
    ("config1_n_valid_tensor", RATE1, 1024, 4096, 3965, 7, 256, 0x2A0000, True),
    ("n_valid_lt_n", RATE1, 64, 4096, 2500, 7, 256, 0x1234567, False),
    ("n_valid_0", RATE1, 64, 512, 0, 7, 256, 0x2345678, True),
    ("n_valid_n_tensor", RATE1, 64, 512, "n", 7, 256, 0x3456789, True),
    ("phase_near_wrap", RATE1, 64, 1024, "n", 7, 256, 0xFFFFFFF0, False),
    ("c5", RATE1, 5, 1000, 997, 7, 256, 77, True),
    ("interpolating_3_3", 3.3, 64, 1000, "n", 7, 256, 0xABCDEF, False),
    ("m3", RATE1, 64, 1000, "n", 3, 256, 0, False),
    ("m12", 0.61, 64, 1000, 990, 12, 256, 5 << 20, True),
    ("npfb64", RATE1, 64, 1000, "n", 7, 64, 0, False),
    ("npfb4096_table_l1", 0.77, 40, 1000, "n", 7, 4096, 999, False),
    ("rate_0_3_passes", 0.3, 33, 2000, 1999, 7, 256, 0x7FFFFFFF, True),
]


@pytest.mark.parametrize("rate, C, n, n_valid, m, npfb, phase, as_tensor",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_kernel_against_its_plain_version(dev, rate, C, n, n_valid, m, npfb, phase, as_tensor):
    rng = np.random.default_rng(C + n + m + npfb)
    rs = Resamp.create(rate, m=m, npfb=npfb, batch_shape=(C,), device=dev).set_rate(rate)
    x, window = _cx(rng, (C, n), dev), _cx(rng, (C, rs.sub_len), dev)
    nv = n if n_valid == "n" else n_valid
    nv = torch.tensor(nv, device=dev) if as_tensor else nv
    cap = rs.out_capacity(n + 1 if rate < 1 else n)  # a decimating MsResamp's capacity
    phase = torch.tensor(phase, dtype=torch.int64, device=dev)
    c, err = _held(*_run(x, window, rs, phase, nv, cap))
    print(f"{C} x {n} at rate {rate} (L {rs.sub_len}, {npfb} branches): {c} of {cap} outputs, "
          f"largest |y − plain| / rms {err:.3e}")
    if rate > 2:
        assert c >= 2 * int(torch.as_tensor(nv))


def test_three_blocks_against_one_long_one(dev):
    """A stream cut into three blocks gives the one long block's valid
    outputs bit for bit, its count and its carried phase and window."""
    rng = np.random.default_rng(3)
    C, cuts = 256, (1500, 1, 2595)
    rs = Resamp.create(RATE1, batch_shape=(C,), device=dev).set_rate(RATE1)
    x, window = _cx(rng, (C, sum(cuts)), dev), _cx(rng, (C, rs.sub_len), dev)
    phase = torch.tensor(0x5000000, dtype=torch.int64, device=dev)

    def call(blk, win, ph):
        cap = rs.out_capacity(blk.shape[-1])
        return resamp_u32_apply(blk, win, rs.branches, ph, rs.step, blk.shape[-1],
                                out_capacity=cap)

    y1, c1, p1, w1 = call(x, window, phase)
    ys, win, ph, pos = [], window, phase, 0
    for n in cuts:
        y, c, ph, win = call(x[:, pos : pos + n], win, ph)
        ys.append(y[:, : int(c)])
        pos += n
    y3 = torch.cat(ys, dim=1)
    assert y3.shape[1] == int(c1) and torch.equal(_bits(y3), _bits(y1[:, : int(c1)]))
    assert int(ph) == int(p1) and torch.equal(_bits(win), _bits(w1))
