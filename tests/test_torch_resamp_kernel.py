"""The u32 PFB resampler's kernel wrapper, ``kernels/resamp.py::resamp_u32_apply``,
on the CPU, and ``MsResamp``'s decimation with no halfband stage.

* The wrapper's argument checks raise.
* Its CPU route, the plain version, equals a frozen copy of the torch u32 path
  that ``Resamp.execute_block_n`` ran before the kernel (mask, schedule, frame
  gather, contraction, window gather), output and state bit for bit, from
  zero and nonzero phases, with ``n_valid`` an int or a device tensor.
* ``MsResamp`` at a rate in [0.5, 1) hands its block to the arbitrary stage
  as it is; that equals a frozen copy of the carry path (the block placed
  after the empty carry in a buffer of n + 1, grouped by 1) over split
  blocks, empty ones included: outputs, counts and state bit for bit.
* On the CPU every call counts ``resamp.calls`` and no launch.

The card's test of the kernel is ``tests/test_torch_resamp_card.py``.
"""

import numpy as np
import pytest
import torch

from yagi_tpu_torch import trace
from yagi_tpu_torch._src.struct import U32
from yagi_tpu_torch.filter import MsResamp, Resamp
from yagi_tpu_torch.kernels.resamp import resamp_u32_apply, resamp_u32_reference
from yagi_tpu_torch.nco import Osc

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
SPLITS = (700, 0, 1, 333, 966)


def _cx(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64))


def _bits(t):
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _frozen_u32(window, branches, phase, step, x, n_valid, cap):
    """The torch u32 path of ``Resamp.execute_block_n`` before the kernel:
    (y, count, new_phase, new_window)."""
    n, (npfb, L) = x.shape[-1], branches.shape
    bits = npfb.bit_length() - 1
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64)
    zero = torch.zeros((), dtype=x.dtype)
    x = torch.where(torch.arange(n) < n_valid, x, zero)
    xa = torch.cat([window[..., 1:].to(x.dtype), x], dim=-1)
    acc = phase + torch.arange(cap + 1, dtype=torch.int64) * step
    lo_full = acc & U32
    n_m, lo = (acc >> 24)[:cap], lo_full[:cap]
    branch = (lo >> (24 - bits)) & (npfb - 1)
    valid = n_m < n_valid
    count = valid.sum()
    new_phase = (lo_full.gather(0, count.reshape(1))[0] - ((n_valid & 0xFF) << 24)) & U32
    frames = xa[..., n_m.clamp(0, n - 1)[:, None] + torch.arange(L)]
    dt = torch.promote_types(xa.dtype, branches.dtype)
    y = torch.einsum("...cl,cl->...c", frames.to(dt), branches[branch].flip(-1).to(dt))
    y = torch.where(valid, y, zero)
    sliced = xa[..., (n_valid - 1).clamp(0, n - 1) + torch.arange(L)]
    return y, count, new_phase, torch.where(n_valid > 0, sliced, window.to(x.dtype))


def _args(seed=0, batch=(3,), n=200, npfb=256, m=7, phase=0):
    rs = Resamp.create(0.77, m=m, npfb=npfb, batch_shape=batch, device=DEV)
    win = _cx(seed + 1, batch + (rs.sub_len,))
    return (_cx(seed, batch + (n,)), win, rs.branches, torch.tensor(phase, dtype=torch.int64),
            rs.step)


def _call(x, win, br, ph, st, nv=7, cap=16):
    return resamp_u32_apply(x, win, br, ph, st, nv, out_capacity=cap)


BAD = [
    ("x not a tensor", lambda a: _call(a[0].numpy(), *a[1:]), ValueError),
    ("empty block", lambda a: _call(a[0][..., :0], *a[1:], nv=0), ValueError),
    ("branches 1-d", lambda a: _call(a[0], a[1], a[2][0], *a[3:]), ValueError),
    ("npfb not a power of two", lambda a: _call(a[0], a[1], a[2][:100], *a[3:]), ValueError),
    ("window of another L", lambda a: _call(a[0], a[1][..., 1:], *a[2:]), ValueError),
    ("window of another batch", lambda a: _call(a[0], a[1][:2], *a[2:]), ValueError),
    ("window not a tensor", lambda a: _call(a[0], a[1].numpy(), *a[2:]), TypeError),
    ("phase not 0-d", lambda a: _call(*a[:3], a[3].reshape(1), a[4]), ValueError),
    ("step int32", lambda a: _call(*a[:4], a[4].int()), TypeError),
    ("n_valid past n", lambda a: _call(*a, nv=201), ValueError),
    ("n_valid negative", lambda a: _call(*a, nv=-1), ValueError),
    ("n_valid a float", lambda a: _call(*a, nv=3.0), ValueError),
    ("n_valid int32 tensor", lambda a: _call(*a, nv=torch.tensor(3, dtype=torch.int32)),
     TypeError),
    ("n_valid 1-d tensor", lambda a: _call(*a, nv=torch.tensor([3])), ValueError),
    ("out_capacity 0", lambda a: _call(*a, cap=0), ValueError),
    ("out_capacity a float", lambda a: _call(*a, cap=16.0), ValueError),
    ("on the meta device", lambda a: _call(*(t.to("meta") for t in a)), ValueError),
]


@pytest.mark.parametrize("call, exc", [b[1:] for b in BAD], ids=[b[0] for b in BAD])
def test_argument_checks_raise(call, exc):
    with pytest.raises(exc):
        call(_args())


# (id, batch, n, n_valid, cap, npfb, m, phase)
CASES = [
    ("config1_like", (4,), 512, 512, 504, 256, 7, 0),
    ("n_valid_lt_n", (4,), 512, 300, 504, 256, 7, 0),
    ("n_valid_0", (4,), 512, 0, 504, 256, 7, 0x12345678),
    ("phase_near_wrap", (4,), 512, 512, 504, 256, 7, 0xFFFFFF00),
    ("phase_past_block", (2,), 3, 3, 8, 256, 7, 5 << 24),
    ("unbatched", (), 300, 250, 320, 256, 7, 77),
    ("batch_2x3", (2, 3), 300, 299, 320, 64, 3, 1 << 23),
    ("m12_npfb_64", (3,), 400, 400, 416, 64, 12, 0),
    ("capacity_short", (3,), 400, 400, 100, 256, 7, 0),
]


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("batch, n, n_valid, cap, npfb, m, phase", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cpu_route_is_the_frozen_torch_path(batch, n, n_valid, cap, npfb, m, phase, as_tensor):
    x, win, br, ph, st = _args(seed=n + cap, batch=batch, n=n, npfb=npfb, m=m, phase=phase)
    nv = torch.tensor(n_valid) if as_tensor else n_valid
    got = resamp_u32_apply(x, win, br, ph, st, nv, out_capacity=cap)
    want = _frozen_u32(win, br, ph, st, x, n_valid, cap)
    for name, a, b in zip(("y", "count", "phase", "window"), got, want):
        assert _same(a, b), name
    assert _same(got[0], resamp_u32_reference(x, win, br, ph, st, nv, out_capacity=cap)[0])
    count = int(got[1])
    assert 0 <= count <= cap and not _bits(got[0])[..., count:, :].any()


def test_an_interpolating_rate_emits_several_outputs_a_sample():
    rs = Resamp.create(3.3, batch_shape=(2,), device=DEV).set_rate(3.3)  # no static schedule
    x = _cx(5, (2, 100))
    got = resamp_u32_apply(x, rs.window, rs.branches, rs.phase, rs.step, 100, out_capacity=344)
    want = _frozen_u32(rs.window, rs.branches, rs.phase, rs.step, x, 100, 344)
    assert all(_same(a, b) for a, b in zip(got, want)) and int(got[1]) == 330


def _carry_path(ms: MsResamp, x):
    """``MsResamp.execute_block``'s decimation through its carry buffer, as
    every decimating MsResamp ran it before the zero-stage branch."""
    n, batch = x.shape[-1], x.shape[:-1]
    m = 1 << ms.num_halfband_stages
    cl = ms.carry_len.to(torch.int64)
    capb = -(-(n + m) // m) * m
    carry_pad = torch.cat([ms.carry.to(x.dtype), x.new_zeros(batch + (capb - m,))], dim=-1)
    xext = torch.cat([x.new_zeros(batch + (m,)), x, x.new_zeros(batch + (capb - n,))], dim=-1)
    pos = torch.arange(capb)
    buf = torch.where(pos >= cl, xext[..., (m - cl) + pos], carry_pad)
    total = cl + n
    rem = total % m
    y1, k1, hb = ms.halfband.execute_block_n(buf, total - rem)
    y2, k2, arb = ms.arbitrary.execute_block_n(y1, k1)
    pos_m = torch.arange(m)
    new_carry = buf[..., (total - rem).clamp(0, capb - m) + pos_m]
    new_carry = torch.where(pos_m < rem, new_carry, x.new_zeros(()))
    return y2, k2, ms.replace(halfband=hb, arbitrary=arb, carry=new_carry, carry_len=rem)


@pytest.mark.parametrize("interp", ["farrow", "pfb"])
@pytest.mark.parametrize("rate", [0.5, 0.61, 2.0 / 2.0663, 0.999])
def test_zero_stage_decimation_equals_the_carry_path(rate, interp):
    ms = MsResamp.create(rate, batch_shape=(3,), arbitrary_interp=interp, device=DEV)
    assert ms.num_halfband_stages == 0 and not ms.interp
    ref, x, pos = ms, _cx(11, (3, sum(SPLITS))), 0
    for n in SPLITS:
        blk = x[:, pos : pos + n]
        pos += n
        y, k, ms = ms.execute_block(blk)
        y_r, k_r, ref = _carry_path(ref, blk)
        assert _same(y, y_r) and _same(k, k_r) and y.shape[-1] == ms.out_capacity(n)
        a, b = ms.arbitrary, ref.arbitrary
        assert _same(a.phase, b.phase) and _same(a.window, b.window)
        assert a.exact_sched == b.exact_sched is None
        assert _same(ms.carry, ref.carry) and _same(ms.carry_len, ref.carry_len)


def test_halfband_stages_keep_the_carry_path():
    ms = MsResamp.create(0.3, batch_shape=(2,), device=DEV)
    ref, x, pos = ms, _cx(12, (2, sum(SPLITS))), 0
    for n in SPLITS:
        y, k, ms = ms.execute_block(x[:, pos : pos + n])
        y_r, k_r, ref = _carry_path(ref, x[:, pos : pos + n])
        pos += n
        assert _same(y, y_r) and _same(k, k_r) and _same(ms.carry, ref.carry)


def test_cpu_counts_calls_and_no_launch():
    before = resamp_u32_apply.launches
    trace.reset()
    rs = Resamp.create(0.77, batch_shape=(2,), device=DEV)
    x = _cx(13, (2, 300))
    _, _, rs = rs.execute_block(x)  # the general path
    _, _, rs = rs.execute_block_n(x, torch.tensor(200))
    _, _, rs, _ = rs.execute_block_mix_down(x, Osc.create("nco", device=DEV).set_frequency(0.2))
    _, _, ms = MsResamp.create(0.9, batch_shape=(2,), device=DEV).execute_block(x)
    counters = trace.snapshot()["counters"]
    assert counters["resamp.calls"] == 4 and resamp_u32_apply.launches == before
    assert counters["resamp.frame_bytes"] == 2 * 14 * 8 * (3 * rs.out_capacity(300)
                                                          + ms.out_capacity(300))
