"""yagi_tpu_torch's QamRx (BASELINE config[3]: AGC → Symsync at 2 samples
per symbol → 7-tap LMS equalizer and carrier PLL → 16-QAM decisions) and the
plain version of its eq/carrier loop kernel against yagi_tpu's QamRx, on the
CPU.

The port has one route, yagi_tpu's decoupled formulation; it is held against
yagi_tpu's ``step_masked`` (on the CPU its fused scan) and
``_step_masked_decoupled``. XLA's CPU backend contracts a·b + c into an FMA
and has its own exp, log, cos and sin, while the port rounds every op as its
CUDA kernels do, so the loops' states differ by ulps: masks and decided
symbols are equal, soft values, θ and the equalizer taps are held to 1e-5
absolute (measured ≤ 1.7e-6, 1.1e-7 and 4.9e-7 over two blocks of the
impaired signal), the AGC gain to 1e-5 relative (≤ 1.3e-6), the running
EVM to 1e-3 dB (≤ 1.9e-5), τ to 1e-4 (≤ 4.8e-7). Over longer streams a
timing decision can fall an ulp the other way at a τ wrap and move one
emission by an input sample (seen after ~2900 samples in one of four
impaired channels), so the parity cases stop at 2400 samples; the port's own
decoding is checked over the whole 6000. Against itself the port is bit-exact
across block splits. The CUDA kernels run only on a GPU; chip_smoke.py holds
them against these plain versions there, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.chains import QamRx as JQamRx
from yagi_tpu.design import FirFilterShape as JShape
from yagi_tpu.design import fir_design_prototype
from yagi_tpu.filter import FirInterpolationFilter
from yagi_tpu.modem import Modem as JModem
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.chains import QamRx
from yagi_tpu_torch._src.device import resolve_device
from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.kernels.qam import STATE_FIELDS, qam_eq_scan_apply, qam_eq_scan_reference
from yagi_tpu_torch.modem import Modem
from yagi_tpu_torch.utils import compact_valid

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

K, M, BETA = 2, 7, 0.3
C_SIG, NSYM = 4, 3000  # impaired 16-QAM channels and symbols sent in each
N_PARITY = 1200  # samples per block in the parity cases (two blocks)
TOL = 1e-5  # soft values, θ, dθ, equalizer taps (absolute); AGC gain (relative)
EVM_TOL_DB = 1e-3
TAU_TOL = 1e-4


def _tx(seed):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 16, NSYM).astype(np.uint32)
    pts, _ = JModem.create("qam16").modulate(jnp.asarray(syms))
    h = fir_design_prototype(JShape.RRCOS, K, M, BETA)
    sig, _ = FirInterpolationFilter.create(K, h).execute_block(pts)
    return syms, np.asarray(sig).astype(np.complex64)


def _impair(sig, seed):
    """tests/test_qamrx.py:69-78: echo, gain, phase, CFO, noise."""
    rng = np.random.default_rng(seed)
    n = len(sig)
    s = sig + 0.1 * np.roll(sig, 3) * np.exp(1j * 1.1)
    s = 0.5 * s * np.exp(1j * (0.3 + 1e-4 * np.arange(n)))
    return (s + (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.002).astype(np.complex64)


@pytest.fixture(scope="module")
def impaired():
    """C_SIG channels, each its own symbols and noise: (sent [C, NSYM],
    received [C, 2·NSYM])."""
    txs = [_tx(42 + c) for c in range(C_SIG)]
    x = np.stack([_impair(s, 3 + c) for c, (_, s) in enumerate(txs)])
    return np.stack([t[0] for t in txs]), x


def _noise(seed=9, c=8, n=512):
    """tests/test_qamrx.py:130-133."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))) * 0.5).astype(np.complex64)


def _same_outputs(t_out, j_out):
    syms_t, soft_t, mask_t = (v.numpy() for v in t_out[:3])
    syms_j, soft_j, mask_j = (np.asarray(v) for v in j_out[:3])
    assert syms_t.dtype == np.int64 and soft_t.dtype == np.complex64 and mask_t.dtype == bool
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(syms_t[mask_t], syms_j[mask_j])
    np.testing.assert_allclose(soft_t, soft_j, rtol=0, atol=TOL)


def _same_state(t, j):
    for f in ("theta", "dtheta"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.eq.w.numpy(), np.asarray(j.eq.w), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.agc.g.numpy(), np.asarray(j.agc.g), rtol=TOL, atol=0)
    np.testing.assert_allclose(t.get_evm().numpy(), np.asarray(j.get_evm()), rtol=0, atol=EVM_TOL_DB)
    np.testing.assert_allclose(t.symsync.tau.numpy(), np.asarray(j.symsync.tau), rtol=0, atol=TAU_TOL)
    for f in ("sym_phase", "evm_count", "overflow_count"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    np.testing.assert_array_equal(t.eq.count.numpy(), np.asarray(j.eq.count))


def test_step_masked_matches_yagi_tpu_on_impaired_qam(impaired):
    """Two blocks of N_PARITY samples of the impaired 16-QAM signal, C = 4,
    against yagi_tpu's fused (its CPU route) and decoupled formulations."""
    _, x = impaired
    j = jd = JQamRx.create(batch_shape=(C_SIG,))
    t = QamRx.create(batch_shape=(C_SIG,), device=DEV)
    for i in range(2):
        blk = x[:, i * N_PARITY:(i + 1) * N_PARITY]
        *jo, j = j.step_masked(jnp.asarray(blk))
        *do, jd = jd._step_masked_decoupled(jnp.asarray(blk))
        *to, t = t.step_masked(torch.from_numpy(blk))
        assert to[0].shape == (C_SIG, 2 * N_PARITY)
        _same_outputs(to, jo)
        _same_outputs(to, do)
        _same_state(t, j)
        _same_state(t, jd)
    assert int(t.evm_count.min()) > 300  # the equalizer adapted in every channel


def test_step_masked_matches_yagi_tpu_on_noise():
    """C = 8, n = 512 of noise (tests/test_qamrx.py::TestDecoupledPath)."""
    x = _noise()
    j = JQamRx.create(batch_shape=(8,))
    *jo, j = j.step_masked(jnp.asarray(x))
    *to, t = QamRx.create(batch_shape=(8,), device=DEV).step_masked(torch.from_numpy(x))
    _same_outputs(to, jo)
    _same_state(t, j)


def _tail_ser(got, want):
    """tests/test_qamrx.py::_tail_ser: the best of 40 alignments."""
    best = 1.0
    for off in range(40):
        L = min(len(got) - off, len(want))
        tl = slice(3 * L // 4, L)
        best = min(best, float(np.mean(got[off:off + L][tl] != want[:L][tl])))
    return best


def test_decodes_impaired_qam(impaired):
    """The port alone over the whole signal in four blocks: tail symbol error
    rate 0 and tail EVM < −25 dB in every channel, the carrier loop moved off
    0, no deferred emission (tests/test_qamrx.py::test_impaired_channel)."""
    sent, x = impaired
    t = QamRx.create(batch_shape=(C_SIG,), device=DEV)
    syms, soft, cnt = [], [], []
    for blk in np.split(x, 4, axis=-1):
        s, v, n, t = t.step(torch.from_numpy(blk))
        syms.append(s.numpy())
        soft.append(v.numpy())
        cnt.append(n.numpy())
    table = t.table.numpy()
    for c in range(C_SIG):
        got = np.concatenate([s[c, :n[c]] for s, n in zip(syms, cnt)])
        sv = np.concatenate([v[c, :n[c]] for v, n in zip(soft, cnt)])
        assert _tail_ser(got, sent[c]) == 0.0
        evm = 10 * np.log10(np.mean(np.abs(sv[-800:, None] - table).min(1) ** 2))
        assert evm < -25.0, (c, evm)
    assert (np.abs(np.remainder(t.theta.numpy(), 2 * np.pi)) > 0.05).all()
    assert not t.overflow_count.any()


def test_block_split_is_exact():
    x = torch.from_numpy(_noise())
    rx = QamRx.create(batch_shape=(8,), device=DEV)
    *one, s1 = rx.step_masked(x)
    *a, s2 = rx.step_masked(x[:, :200])
    *b, s2 = s2.step_masked(x[:, 200:], samples_per_step=8)
    for o, u, v in zip(one, a, b):
        assert torch.equal(o, torch.cat([u, v], -1))
    for f in ("theta", "dtheta", "sym_phase", "evm_accum", "evm_count", "overflow_count"):
        assert torch.equal(getattr(s1, f), getattr(s2, f))
    assert torch.equal(s1.eq.w, s2.eq.w) and torch.equal(s1.agc.g, s2.agc.g)
    assert torch.equal(s1.symsync.tau, s2.symsync.tau)


def test_step_compacts_reset_and_evm():
    x = torch.from_numpy(_noise(seed=10))
    rx = QamRx.create(batch_shape=(8,), device=DEV)
    syms_m, soft_m, mask, _ = rx.step_masked(x)
    syms, soft, num, new = rx(x)
    assert torch.equal(num, mask.sum(-1))
    assert torch.equal(syms, compact_valid(syms_m, mask)[0])
    assert torch.equal(soft, compact_valid(soft_m, mask)[0])
    ms = new.evm_accum / torch.clamp(new.evm_count, min=1.0)
    assert torch.equal(new.get_evm(), 10.0 * torch.log10(torch.clamp(ms, min=1e-12)))
    r = new.reset()
    fresh = QamRx.create(batch_shape=(8,), device=DEV)
    for f in ("theta", "dtheta", "sym_phase", "evm_accum", "evm_count", "overflow_count"):
        assert torch.equal(getattr(r, f), getattr(fresh, f)), f
    assert torch.equal(r.eq.w, fresh.eq.w) and torch.equal(r.agc.g, fresh.agc.g)
    assert not r.symsync.window.any()


def test_create_and_controls_match_yagi_tpu():
    j = JQamRx.create(batch_shape=(3,)).set_bandwidth(0.05)
    t = QamRx.create(batch_shape=(3,), device=DEV).set_bandwidth(0.05)
    assert (t.k, t.k_eq, t.slots, t.eq.h_len) == (j.k, j.k_eq, j.slots, j.eq.h_len)
    for f in ("table", "alpha", "beta", "sym_phase", "theta"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    np.testing.assert_array_equal(t.agc.alpha.numpy(), np.asarray(j.agc.alpha))
    np.testing.assert_array_equal(t.eq.mu.numpy(), np.asarray(j.eq.mu))
    np.testing.assert_array_equal(t.symsync.mf.numpy(), np.asarray(j.symsync.mf))
    assert t.symsync.k_out == j.symsync.k_out == 2


@pytest.mark.parametrize("make", [
    lambda: QamRx.create("rrcos", 1, M, BETA, device=DEV),
    lambda: QamRx.create("rrcos", K, M, 1.5, device=DEV),
    lambda: QamRx.create("rrcos", K, M, BETA, eq_len=6, device=DEV),
    lambda: QamRx.create("rrcos", K, M, BETA, device=DEV).set_bandwidth(-0.1),
    lambda: QamRx.create(batch_shape=(2,), device=DEV).step_masked(
        torch.zeros(2, 10, dtype=torch.complex64), samples_per_step=3),
])
def test_rejects_bad_config(make):
    """tests/test_qamrx.py:111-120, and samples_per_step not dividing n."""
    with pytest.raises(ConfigError):
        make()


def test_overflow_count_matches_yagi_fused_route():
    """A symsync whose rate and δ are 0.4, below half of nominal (1 at
    k_out = 2), defers an emission past the two slots after every sample;
    the port's count equals yagi_tpu's fused route."""
    j = JQamRx.create(batch_shape=(8,))
    slow = jnp.full((8,), 0.4, jnp.float32)
    j = j.replace(symsync=j.symsync.replace(rate=slow, delta=slow))
    t = load_state(QamRx, j, device=DEV)
    x = _noise(seed=11, n=256)
    *jo, j = j.step_masked(jnp.asarray(x))
    *to, t = t.step_masked(torch.from_numpy(x))
    assert int(t.overflow_count.min()) > 0
    np.testing.assert_array_equal(t.overflow_count.numpy(), np.asarray(j.overflow_count))
    np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))


def test_eq_scan_reference_matches_yagi_eq_scan():
    """``qam_eq_scan_reference`` fed yagi_tpu's decoupled slots (its AGC and
    symsync on the same block) against yagi_tpu's eq-only scan; the wrapper
    runs the plain version on CPU tensors, bit for bit, with no launch."""
    x = _noise(seed=12)
    j = JQamRx.create(batch_shape=(8,))
    y0, _ = j.agc.execute_block(jnp.asarray(x), samples_per_step=8)
    ys, vs, _ = j.symsync.execute_slots(y0, max_emit=j.slots)
    *jo, jn = j._step_masked_decoupled(jnp.asarray(x))
    t = load_state(QamRx, j, device=DEV)
    slots = (torch.from_numpy(np.asarray(ys)).reshape(8, -1),
             torch.from_numpy(np.asarray(vs)).reshape(8, -1))
    launches = qam_eq_scan_apply.launches
    ref = qam_eq_scan_reference(*slots, *t.eq_scan_args(), k_eq=2)
    out = qam_eq_scan_apply(*slots, *t.eq_scan_args(), k_eq=2)
    assert qam_eq_scan_apply.launches == launches
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert all(torch.equal(out[3][f], ref[3][f]) for f in ref[3])
    _same_outputs(ref, jo)
    st = ref[3]
    np.testing.assert_allclose(st["theta"].numpy(), np.asarray(jn.theta), rtol=0, atol=TOL)
    np.testing.assert_allclose(st["w"].numpy(), np.asarray(jn.eq.w), rtol=0, atol=TOL)
    np.testing.assert_allclose(st["evm_accum"].numpy(), np.asarray(jn.evm_accum), rtol=TOL)
    for f, want in (("count", jn.eq.count), ("sym_phase", jn.sym_phase), ("evm_count", jn.evm_count)):
        np.testing.assert_array_equal(st[f].numpy(), np.asarray(want))


def test_load_state_round_trip():
    """A yagi_tpu QamRx after one block loads whole (Agc, Symsync, Eqlms,
    table) and continues as yagi_tpu does."""
    x = _noise(seed=13)
    _, _, _, j = JQamRx.create(batch_shape=(8,)).step_masked(jnp.asarray(x[:, :256]))
    t = load_state(QamRx, j, device=DEV)
    assert t.agc.squelch_mode.dtype == torch.int32 and t.eq.count.dtype == torch.int32
    assert t.symsync.b.dtype == torch.int32 and t.table.dtype == torch.complex64
    np.testing.assert_array_equal(t.eq.w.numpy(), np.asarray(j.eq.w))
    *jo, j = j.step_masked(jnp.asarray(x[:, 256:]))
    *to, t = t.step_masked(torch.from_numpy(x[:, 256:]))
    _same_outputs(to, jo)
    _same_state(t, j)


@pytest.mark.parametrize("bad", ["rank", "keys", "y_dtype", "mu_shape", "count_dtype", "table"])
def test_eq_scan_apply_rejects_bad_input(bad):
    rx = QamRx.create(batch_shape=(2,), device=DEV)
    table, mu, alpha, beta, state = rx.eq_scan_args()
    y = torch.zeros(2, 16, dtype=torch.complex64)
    valid = torch.ones(2, 16, dtype=torch.bool)
    if bad == "rank":
        y = y[0]
    elif bad == "keys":
        state = {k: v for k, v in state.items() if k != "x2"}
    elif bad == "y_dtype":
        y = y.to(torch.complex128)
    elif bad == "mu_shape":
        mu = mu[:1]
    elif bad == "count_dtype":
        state = dict(state, count=state["count"].long())
    else:
        table = table[None]
    with pytest.raises((ValueError, TypeError)):
        qam_eq_scan_apply(y, valid, table, mu, alpha, beta, state)


def _serial_argmin(d):
    """The decision as one thread takes it: a strict < from index 0, a NaN
    distance counting as smallest (the first NaN wins)."""
    best, arg = d[0], 0
    for m in range(1, len(d)):
        if d[m] < best or (np.isnan(d[m]) and not np.isnan(best)):
            best, arg = d[m], m
    return arg


def _lane_argmin(d, lanes=16):
    """The decision as lanes take it: lane l scans m ≡ l (mod lanes), then the
    lexicographic minimum of (not NaN, distance, index) over the lanes."""
    def key(m):
        return (not np.isnan(d[m]), 0.0 if np.isnan(d[m]) else d[m], m)

    return min((min(range(l, len(d), lanes), key=key) for l in range(min(lanes, len(d)))), key=key)


@pytest.mark.parametrize("case", ["qpsk", "qam16", "qam64", "nan_points", "nan_slots"])
def test_eq_scan_reference_takes_the_first_minimum(case):
    """A fresh equalizer on zero slots outputs exactly 0, equidistant from the
    nearest 4 points of a QPSK, 16- or 64-QAM table: ``qam_eq_scan_reference``
    decides the first of them, as the serial scan and the lanes' rule both
    do. A NaN distance is smallest and the first NaN wins: NaN table points
    at indices 5 and 9, or NaN slots (every distance NaN, so index 0)."""
    c, n = 3, 16
    rx = QamRx.create(batch_shape=(c,), device=DEV)
    table, mu, alpha, beta, state = rx.eq_scan_args()
    scheme = case if case.startswith("q") else "qam16"
    table = Modem.create(scheme, device=DEV).table.clone()
    y = torch.zeros(c, n, dtype=torch.complex64)
    if case == "nan_points":
        table[[5, 9]] = complex("nan+nanj")
    elif case == "nan_slots":
        y[:, 3::4] = complex("nan+nanj")
    valid = torch.ones(c, n, dtype=torch.bool)
    syms, soft, mask, _ = qam_eq_scan_reference(y, valid, table, mu, alpha, beta, state, k_eq=2)
    t = table.numpy()
    for ci in range(c):
        for s in range(n):
            v = soft[ci, s].numpy()
            d = ((v.real - t.real) ** 2 + (v.imag - t.imag) ** 2).astype(np.float32)
            want = _serial_argmin(d)
            assert _lane_argmin(d) == _lane_argmin(d, lanes=8) == want
            assert int(syms[ci, s]) == want, (ci, s)
    if case == "nan_points":
        assert (syms == 5).all()
    elif case == "nan_slots":
        assert (syms[:, 3::4] == 0).all() and soft[:, 3::4].isnan().all()
    else:  # a tie among the nearest points, broken to the lowest index
        d = (np.abs(t) ** 2).astype(np.float32)
        assert (d == d.min()).sum() == 4 and (syms == int(np.argmin(d))).all()


def test_create_without_a_device_needs_the_card(monkeypatch):
    """Entry points default to the card: with torch seeing no CUDA device,
    QamRx.create() raises DeviceError naming the fix; device="cpu" builds
    every tensor on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        QamRx.create()
    with pytest.raises(DeviceError):
        load_state(QamRx, JQamRx.create(batch_shape=(2,)))
    rx = QamRx.create(batch_shape=(2,), device="cpu")
    tensors = [rx.table, rx.theta, rx.agc.g, rx.symsync.tau, rx.symsync.mf, rx.eq.w, rx.overflow_count]
    assert all(t.device.type == "cpu" for t in tensors)


def test_resolve_device_picks_the_current_card(monkeypatch):
    """None is the current CUDA device; an explicit device passes through."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device(None) == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 0)) == torch.device("cuda", 0)


# --------------------------------------------------- equalizers past 16 taps
def test_step_masked_with_a_17_tap_equalizer_matches_yagi_tpu(impaired):
    """eq_len = 17, which the card runs on the kernel's shared-memory
    instance: two blocks of the impaired signal against yagi_tpu."""
    _, x = impaired
    j = JQamRx.create(eq_len=17, batch_shape=(C_SIG,))
    t = QamRx.create(eq_len=17, batch_shape=(C_SIG,), device=DEV)
    for i in range(2):
        blk = x[:, i * N_PARITY:(i + 1) * N_PARITY]
        *jo, j = j.step_masked(jnp.asarray(blk))
        *to, t = t.step_masked(torch.from_numpy(blk))
        _same_outputs(to, jo)
        _same_state(t, j)
    assert t.eq.w.shape == (C_SIG, 17) and int(t.evm_count.min()) > 300


@pytest.mark.parametrize("h_len, m, fits", [(7, 16, True), (16, 64, True), (17, 16, True),
                                             (654, 16, True), (655, 16, False)])
def test_eq_scan_shared_memory_need(h_len, m, fits):
    """The wrapper's mirror of csrc/qam.cu's shared-memory layout: up to 16
    taps (the instance that runs rounds: 16 channels a block, 64-slot tiles,
    rings of 256 valid samples and 15 copies) the window lives in registers and adds
    nothing; past 16, each channel's window and weights."""
    from yagi_tpu_torch.kernels import qam

    if h_len <= qam.MAX_REG_H_LEN:
        tile, ring = 16 * 65, 16 * (256 + 16 + 1)
        need = (8 * (m + 3 * tile + ring) + 4 * (2 * ring + 2 * tile + 2 * 16 * 2 + 2 * 16)
                + 3 * 16 * 68 + 2 * 2 * 16 * 66)
    else:
        need = 8 * (m + 2 * 16 * 65) + 4 * 16 * 65 + 2 * 16 * 68 + 4 * 16 * ((5 * h_len) | 1)
    assert qam.smem_bytes(m, h_len) == need
    assert (qam.smem_bytes(m, h_len) <= qam._SMEM_LIMIT) == fits


# ------------------------------------------- the kernel's order: rounds over segments
def _bits(t):
    """A tensor's bits (complex as its float32 pairs), so NaNs compare equal."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _segment_order_scan(y, valid, table, mu, alpha, beta, state, *, k_eq, slots, tile):
    """``qam_eq_scan`` in ``csrc/qam.cu``'s order, in plain torch: the plain
    version's ``(syms, soft, mask, state)``, and the rounds summed over
    channels.

    The plan comes from the inputs alone: slot by slot, the window's valid
    samples, Σ|x|² as (x2_sum + |x|²) − x2[0], the count and sym_phase, hence
    each slot's is_sym and can_adapt; then each channel's rounds, cut after
    every adapting slot, every ``slots`` slots and every ``tile`` slots.
    Round r of every channel runs at once: each of its slots decided from
    the state its segment started with, the state updated only at its last
    slot, where that slot adapts."""
    C, S = y.shape
    H = state["w"].shape[1]
    rows = torch.arange(C)
    # the plan: hist / x2h hold the window's samples and |x|², oldest first,
    # then each valid slot's; a slot with v valid slots before it pushes onto
    # hist[v + 1 : v + H] and drops x2h[v]
    hist = torch.zeros(C, H + S, dtype=torch.complex64)
    hist[:, :H] = state["buffer"]
    x2h = torch.zeros(C, H + S)
    x2h[:, :H] = state["x2"]
    x2s, cnt, sph = state["x2_sum"], state["count"], state["sym_phase"]
    nv = torch.zeros(C, dtype=torch.long)
    vidx = torch.zeros(C, S, dtype=torch.long)
    x2sp = torch.zeros(C, S)
    is_sym = torch.zeros(C, S, dtype=torch.bool)
    can = torch.zeros(C, S, dtype=torch.bool)
    lms = torch.zeros(C, S, dtype=torch.bool)
    for s in range(S):
        xr, xi, vi = y.real[:, s], y.imag[:, s], valid[:, s]
        x2n = xr * xr + xi * xi
        x2s_p = x2s + x2n - x2h[rows, nv]
        is_sym[:, s] = vi & (sph == 0)
        can[:, s] = is_sym[:, s] & (x2s_p > 0.5 * H)
        lms[:, s] = can[:, s] & (cnt + 1 >= H)
        x2sp[:, s], vidx[:, s] = x2s_p, nv
        hist[rows, H + nv] = torch.where(vi, y[:, s], hist[rows, H + nv])
        x2h[rows, H + nv] = torch.where(vi, x2n, x2h[rows, H + nv])
        x2s, cnt = torch.where(vi, x2s_p, x2s), torch.where(vi, cnt + 1, cnt)
        sph = torch.where(vi, sph ^ 1 if k_eq == 2 else (sph + 1) % k_eq, sph)
        nv = nv + vi.long()
    rounds = []  # each channel's rounds: (first slot, slots)
    for c in range(C):
        rs, start = [], 0
        for s in range(S):
            if can[c, s] or s + 1 - start == slots or (s + 1) % tile == 0 or s + 1 == S:
                rs.append((start, s + 1 - start))
                start = s + 1
        rounds.append(rs)
    # the rounds
    wr, wi = state["w"].real, state["w"].imag
    theta, dtheta = state["theta"], state["dtheta"]
    eacc, ecnt = state["evm_accum"], state["evm_count"]
    tr, ti = table.real, table.imag
    syms = torch.zeros(C, S, dtype=torch.int64)
    soft_r, soft_i = torch.zeros(C, S), torch.zeros(C, S)
    k = torch.arange(slots)
    for r in range(max(len(rs) for rs in rounds)):
        act = torch.tensor([r < len(rs) for rs in rounds])
        start = torch.tensor([rs[r][0] if r < len(rs) else 0 for rs in rounds])
        n = torch.tensor([rs[r][1] if r < len(rs) else 1 for rs in rounds])
        last = start + n - 1
        s = torch.minimum(start[:, None] + k, last[:, None])  # [C, slots]
        taps = vidx[rows[:, None], s][..., None] + 1 + torch.arange(H - 1)
        win = torch.cat([hist[rows[:, None, None], taps], y[rows[:, None], s][..., None]], -1)
        br_p, bi_p = win.real, win.imag  # [C, slots, H]
        prod_r, prod_i = wr[:, None] * br_p + wi[:, None] * bi_p, wr[:, None] * bi_p - wi[:, None] * br_p
        yr, yi = prod_r[..., 0], prod_i[..., 0]
        for j in range(1, H):  # left to right
            yr, yi = yr + prod_r[..., j], yi + prod_i[..., j]
        co, sn = torch.cos(theta), torch.sin(theta)  # [C], as the plain version takes them
        vs_r = yr * co[:, None] + yi * sn[:, None]
        vs_i = yi * co[:, None] - yr * sn[:, None]
        dr, di = vs_r[..., None] - tr, vs_i[..., None] - ti
        sym = torch.argmin(dr * dr + di * di, dim=-1)
        out = act[:, None] & (k < n[:, None])
        cs, ss = rows[:, None].expand_as(s)[out], s[out]
        syms[cs, ss], soft_r[cs, ss], soft_i[cs, ss] = sym[out], vs_r[out], vs_i[out]
        e = n - 1  # the round's last slot
        yr_e, yi_e, vr_e, vi_e = yr[rows, e], yi[rows, e], vs_r[rows, e], vs_i[rows, e]
        sr, si = tr[sym[rows, e]], ti[sym[rows, e]]
        br_e, bi_e = br_p[rows, e], bi_p[rows, e]
        pe = (vi_e * sr - vr_e * si) / torch.clamp(sr * sr + si * si, min=1e-12)
        theta_n = theta + dtheta + alpha * pe
        dtheta_n = dtheta + beta * pe
        ar = (sr * co - si * sn) - yr_e
        ai = (si * co + sr * sn) - yi_e
        g = (mu / torch.clamp(x2sp[rows, last], min=1e-20))[:, None]
        wr_u = wr + g * (ar[:, None] * br_e + ai[:, None] * bi_e)
        wi_u = wi + g * (ar[:, None] * bi_e - ai[:, None] * br_e)
        adapt, upd = act & can[rows, last], (act & lms[rows, last])[:, None]
        wr, wi = torch.where(upd, wr_u, wr), torch.where(upd, wi_u, wi)
        theta = torch.where(adapt, theta_n, theta)
        dtheta = torch.where(adapt, dtheta_n, dtheta)
        er, ei = vr_e - sr, vi_e - si
        eacc = torch.where(adapt, eacc + (er * er + ei * ei), eacc)
        ecnt = torch.where(adapt, ecnt + 1.0, ecnt)
    window = nv[:, None] + torch.arange(H)
    new = dict(w=torch.complex(wr, wi), buffer=hist[rows[:, None], window],
               x2=x2h[rows[:, None], window], x2_sum=x2s, count=cnt, theta=theta,
               dtheta=dtheta, sym_phase=sph, evm_accum=eacc, evm_count=ecnt)
    return (syms, torch.complex(soft_r, soft_i), is_sym, new), sum(len(rs) for rs in rounds)


def _eq_case(k_eq, h_len, m, traffic, c=5, n=None):
    """Random slots (valid about ½, or 0.2 for ``sparse``) and a random state:
    the window, its |x|², a count on either side of h_len, θ, dθ, sym_phase
    (one channel's out of range); ``zeros`` puts a run of zero slots in,
    ``nan`` NaN slots in some channels, ``quiet`` scales the slots so that
    Σ|x|² stays under ½·h_len (no slot adapts once the window has filled)."""
    from yagi_tpu_torch.kernels.qam import ROUND_TILE

    n = 2 * ROUND_TILE + 37 if n is None else n
    g = np.random.default_rng(100 * k_eq + 10 * h_len + m + len(traffic))

    def cplx(*shape):
        return torch.from_numpy(((g.standard_normal(shape) + 1j * g.standard_normal(shape))
                                 / np.sqrt(2)).astype(np.complex64))

    y = cplx(c, n)
    valid = torch.from_numpy(g.random((c, n)) < (0.2 if traffic == "sparse" else 0.5))
    if traffic == "zeros":
        y[:, n // 5: n // 2] = 0
    elif traffic == "nan":
        y[::2, n // 3] = complex("nan+nanj")
    elif traffic == "quiet":
        y = y * 0.05
    table = Modem.create({4: "qpsk", 16: "qam16", 64: "qam64"}[m], device=DEV).table
    x2 = torch.from_numpy(g.random((c, h_len)).astype(np.float32) * (0.1 if traffic == "quiet" else 2))
    w = cplx(c, h_len) * 0.1
    w[:, h_len // 2] += 1
    state = dict(w=w, buffer=cplx(c, h_len), x2=x2, x2_sum=x2.sum(1),
                 count=torch.from_numpy(g.integers(0, 2 * h_len + 2, c).astype(np.int32)),
                 theta=torch.from_numpy(g.uniform(-3, 3, c).astype(np.float32)),
                 dtheta=torch.from_numpy(g.uniform(-1e-3, 1e-3, c).astype(np.float32)),
                 sym_phase=torch.from_numpy(g.integers(0, k_eq, c).astype(np.int32)),
                 evm_accum=torch.zeros(c), evm_count=torch.zeros(c))
    state["sym_phase"][0] = -7

    def vec(v):
        return torch.full((c,), v, dtype=torch.float32)

    return y, valid, table, vec(0.02), vec(0.02), vec(0.02 ** 2 / 2), state


@pytest.mark.parametrize("k_eq, h_len, m, traffic", [
    (2, 7, 16, "random"), (1, 7, 16, "random"), (3, 7, 16, "random"), (2, 1, 16, "random"),
    (2, 16, 16, "random"), (2, 7, 4, "random"), (2, 7, 64, "random"), (2, 7, 16, "zeros"),
    (2, 7, 16, "nan"), (2, 7, 16, "quiet"), (3, 16, 64, "sparse"),
])
def test_eq_scan_in_rounds_equals_the_plain_loop(k_eq, h_len, m, traffic):
    """The kernel's order (rounds over segments, csrc/qam.cu) equals
    ``qam_eq_scan_reference`` bit for bit, outputs and every state field, on
    S = 2·tile + 37 slots (not a multiple of the tile); and its rounds are
    the plain loop's segments cut at its state-changing slots (where θ, dθ,
    w or the EVM sums move, one slot at a time), at every tile and every
    ``ROUND_SLOTS`` slots (a longer segment takes more rounds)."""
    from yagi_tpu_torch.kernels.qam import ROUND_SLOTS, ROUND_TILE

    args = _eq_case(k_eq, h_len, m, traffic)
    want = qam_eq_scan_reference(*args, k_eq=k_eq)
    got, rounds = _segment_order_scan(*args, k_eq=k_eq, slots=ROUND_SLOTS, tile=ROUND_TILE)
    for a, b in zip(got[:3], want[:3]):
        assert _same_bits(a, b)
    for f in STATE_FIELDS:
        assert _same_bits(got[3][f], want[3][f]), f
    # the plain loop one slot at a time: the slots after which its state moved
    y, valid, table, mu, alpha, beta, state = args
    C, S = y.shape
    moved = torch.zeros(C, S, dtype=torch.bool)
    for s in range(S):
        *_, new = qam_eq_scan_reference(y[:, s:s + 1], valid[:, s:s + 1], table, mu, alpha, beta,
                                        state, k_eq=k_eq)
        for f in ("w", "theta", "dtheta", "evm_accum", "evm_count"):
            moved[:, s] |= (_bits(new[f]) != _bits(state[f])).reshape(C, -1).any(1)
        state = new
    cuts = [sorted({s + 1 for s in range(S) if moved[c, s]}
                   | set(range(ROUND_TILE, S, ROUND_TILE)) | {S}) for c in range(C)]
    want_rounds = sum(-(-(b - a) // ROUND_SLOTS) for cut in cuts for a, b in zip([0] + cut, cut))
    assert rounds == want_rounds
    if traffic in ("quiet", "sparse"):  # no slot adapts / segments longer than a round
        assert (moved.sum() == 0) == (traffic == "quiet") and rounds > moved.sum() + C * 3
