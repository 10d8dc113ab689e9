"""yagi_tpu_torch's Symsync and its two scan kernels' plain versions against
yagi_tpu (BASELINE config[1]'s symbol synchronizer: RRCOS k = 2, m = 7,
β = 0.3, 32 filters, set_lf_bw(0.02)), at C = 128 channels, n = 256.

* K4's plain version, ``symsync_scan_reference``, against yagi_tpu's Pallas
  ``symsync_scan`` (interpret mode) on the same all-branch stream: masks and
  values equal, and the integer rows of the carried state (b, dec) equal.
  The float rows are not bit-equal: XLA's CPU backend contracts a multiply
  and an add into one FMA (checked: ``c - a*b`` under jit equals the fused
  result, not the two-step one), while the port rounds every op as the CUDA
  kernel does, so the loop filter (v0 = q − a1·v0, rate + radj·q̂) differs
  by an ulp from the eighth sample on. rate, δ, v0 and v1 are held to
  1e-6. τ integrates δ over the block's ~128 timing updates, so τ and
  τ_decim are held to 1e-4 (measured ≤ 1.2e-5), as test_symscan.py's fused
  test holds τ, and bf = 32·τ to 32·1e-4.
* K3's plain version, ``symsync_fused_reference``, against
  ``symsync_scan_fused`` (interpret): masks equal, values < 1e-5·max(|y|, 1)
  (the dots sum in another order).
* ``Symsync.execute_slots`` / ``execute`` on every backend against yagi_tpu's
  XLA scan: masks and counts equal, values < 1e-4·max(|y|, 1), τ within 1e-4,
  across a 128 + 128 block split and with ``n_valid``.

The CUDA kernels run only on a GPU; chip_smoke.py holds them against these
plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.design import FirFilterShape as JShape
from yagi_tpu.filter import Symsync as JSymsync
from yagi_tpu.kernels.symscan import symsync_scan, symsync_scan_fused
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.filter import Symsync
from yagi_tpu_torch.kernels.symscan import (
    FUSED_SMEM_LIMIT,
    branch_outputs,
    fused_fits,
    fused_smem_bytes,
    scan_layout,
    symsync_fused_apply,
    symsync_fused_reference,
    symsync_scan_apply,
    symsync_scan_reference,
    symsync_scan_xla,
)

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

C, N = 128, 256
P, L, LPAD = 32, 28, 32  # config[1]'s bank: 32 branches of 28 taps (TPU pad 32)
SLOT_TOL = 1e-4  # tests/test_symscan.py::TestSymscanFused
FUSED_TOL = 1e-5


def _sig(seed, c=C, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))).astype(np.complex64)


def _pair(c=C, k_out=1):
    j = JSymsync.create_rnyquist(JShape.RRCOS, 2, 7, 0.3, batch_shape=(c,)).set_lf_bw(0.02)
    t = Symsync.create_rnyquist("rrcos", 2, 7, 0.3, batch_shape=(c,), device=DEV).set_lf_bw(0.02)
    if k_out != 1:
        j, t = j.set_output_rate(k_out), t.set_output_rate(k_out)
    return j, t


def _kernel_args(j, rng):
    """The loop's inputs from a yagi_tpu Symsync: its kernel state and
    constants for the Pallas kernels, the port's keyword arguments, and a
    window-prefixed block with a random window."""
    state16, consts = j._kernel_state(C)
    kw = dict(
        state=torch.from_numpy(np.array(state16[:9])),
        locked=torch.from_numpy(np.array(j.locked)),
        radj=torch.from_numpy(np.array(j.rate_adjustment)),
        pll_a=torch.from_numpy(np.array(j.pll_a)),
        pll_b=torch.from_numpy(np.array(j.pll_b)),
        P=P, k_out=j.k_out, k=j.k,
    )
    xa = np.concatenate([_sig(int(rng.integers(1 << 30)), n=L), _sig(int(rng.integers(1 << 30)))], -1)
    g = np.concatenate([np.asarray(j.mf), np.asarray(j.dmf)])[:, ::-1].copy()
    return state16, consts, kw, xa, g


def _vf(n_valid):
    v = np.arange(N) < (N if n_valid is None else n_valid)
    return jnp.asarray(np.broadcast_to(v.astype(np.float32)[:, None], (N, C)))


def _unpack(ys, E):
    """yagi_tpu kernel rows [n, 3E, C] → (y [C, n, E], valid [C, n, E])."""
    ys = np.asarray(ys)
    y = ys[:, :E] + 1j * ys[:, E : 2 * E]
    return y.transpose(2, 0, 1), ys[:, 2 * E :].transpose(2, 0, 1) > 0.5


def _nv(n_valid):
    return None if n_valid is None else torch.tensor(n_valid)


def _check_state(got, want):
    """Rows (b, bf, τ, τ_decim, rate, δ, dec, v0, v1); see the module
    docstring for the tolerances."""
    for rows, atol in (((0, 6), 0.0), ((4, 5, 7, 8), 1e-6), ((2, 3), 1e-4), ((1,), P * 1e-4)):
        np.testing.assert_allclose(got[list(rows)], want[list(rows)], rtol=0, atol=atol)


# ------------------------------------------------------------- K4 (plain)
@pytest.mark.parametrize("k_out", [1, 2])
@pytest.mark.parametrize("n_valid", [None, 200])
def test_scan_reference_matches_pallas_scan(n_valid, k_out):
    j, _ = _pair(k_out=k_out)
    E = 2 if k_out == 1 else 3
    state16, consts, kw, xa, g = _kernel_args(j, np.random.default_rng(1))
    xs4 = branch_outputs(torch.from_numpy(xa), torch.from_numpy(g))
    ys, st = symsync_scan(jnp.asarray(xs4.numpy().transpose(1, 2, 0)), _vf(n_valid), state16,
                          consts, P=P, E=E, k_out=k_out, interpret=True)
    y_want, v_want = _unpack(ys, E)
    y, v, st_t, _ = symsync_scan_reference(xs4, _nv(n_valid), E=E, **kw)
    assert y.shape == (C, N, E) and y.dtype == torch.complex64 and v.dtype == torch.bool
    np.testing.assert_array_equal(v.numpy(), v_want)
    np.testing.assert_array_equal(y.numpy(), y_want)
    _check_state(st_t.numpy(), np.asarray(st)[:9])
    if n_valid is not None:
        assert not v[:, n_valid:].any()


def test_branch_outputs_is_block_length_invariant():
    """Each all-branch output depends only on its own L samples: a block and
    its halves give identical bits (K4's stream under a block split)."""
    j, _ = _pair()
    _, _, _, xa, g = _kernel_args(j, np.random.default_rng(2))
    xa, g = torch.from_numpy(xa), torch.from_numpy(g)
    whole = branch_outputs(xa, g)
    h = N // 2
    parts = [branch_outputs(xa[:, : h + L], g), branch_outputs(xa[:, h:], g)]
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), whole.numpy())


# ------------------------------------------------------------- K3 (plain)
@pytest.mark.parametrize("n_valid", [None, 200])
def test_fused_reference_matches_pallas_fused(n_valid):
    j, _ = _pair()
    state16, consts, kw, xa, g = _kernel_args(j, np.random.default_rng(3))
    xt = xa[:, 1:].T
    pad = [(0, N + LPAD - xt.shape[0]), (0, 0)]
    g2 = np.pad(g, [(0, 0), (0, LPAD - L)])
    ys, _ = symsync_scan_fused(jnp.asarray(np.pad(xt.real, pad)), jnp.asarray(np.pad(xt.imag, pad)),
                               _vf(n_valid), state16, consts, jnp.asarray(g2), P=P, E=2,
                               k_out=1, interpret=True)
    y_want, v_want = _unpack(ys, 2)
    y, v, _, _ = symsync_fused_reference(torch.from_numpy(xa), torch.from_numpy(g), _nv(n_valid),
                                      E=2, **kw)
    np.testing.assert_array_equal(v.numpy(), v_want)
    assert np.abs(y.numpy() - y_want).max() < FUSED_TOL * max(np.abs(y_want).max(), 1.0)


def _lane_dots(xa, g):
    """K3's dots in numpy float32, one rounded op at a time: lane l of a dot
    sums the products of taps j ≡ l (mod 4) in increasing j (0 where it
    has none), then the lanes combine as (s0 + s1) + (s2 + s3)."""
    n = xa.shape[1] - g.shape[1]
    out = []
    for plane in (xa.real[:, 1:], xa.imag[:, 1:]):
        sums = []
        for lane in range(4):
            acc = np.zeros((xa.shape[0], n, g.shape[0]), np.float32)
            for i, j in enumerate(range(lane, g.shape[1], 4)):
                term = plane[:, j:j + n, None] * g[:, j]
                acc = term if i == 0 else acc + term
            sums.append(acc)
        out.append((sums[0] + sums[1]) + (sums[2] + sums[3]))
    return np.concatenate(out, -1)


@pytest.mark.parametrize("taps", [3, 13, 18, 37])
def test_branch_outputs_are_the_dots_the_fused_loop_picks(taps):
    """For L not a multiple of 4 (L < 4, lanes without a tap; L > 32, taps
    past K3's unrolled ones):
    ``branch_outputs`` equals K3's lane order worked out independently, and
    ``symsync_fused_reference`` equals K4's loop over that stream, so the
    fused loop picks exactly those dots."""
    rng = np.random.default_rng(30 + taps)
    c, n = 9, 40
    _, t = _pair(c=c)
    kw = t.kernel_args()
    g = (0.3 * rng.standard_normal((2 * kw["P"], taps))).astype(np.float32)
    xa = _sig(taps, c=c, n=n + taps)
    want = _lane_dots(xa, g)
    got = branch_outputs(torch.from_numpy(xa), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    fused = symsync_fused_reference(torch.from_numpy(xa), torch.from_numpy(g), _nv(30), E=2, **kw)
    loop = symsync_scan_reference(torch.from_numpy(want), _nv(30), E=2, **kw)
    assert int(fused[1].sum()) > 0
    for a, b in zip(fused, loop):
        assert torch.equal(a, b)


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the kernel wrappers run the plain versions and count no
    launch; K4's plain version and the XLA-form scan agree bit for bit at
    k = 2 (x·(1/2) and x/2 are the same float)."""
    j, _ = _pair()
    _, _, kw, xa, g = _kernel_args(j, np.random.default_rng(4))
    xa, g = torch.from_numpy(xa), torch.from_numpy(g)
    xs4 = branch_outputs(xa, g)
    n3, n4 = symsync_fused_apply.launches, symsync_scan_apply.launches
    outs = [symsync_scan_apply(xs4, None, E=2, **kw), symsync_scan_reference(xs4, None, E=2, **kw),
            symsync_scan_xla(xs4, None, E=2, **kw)]
    fused = [symsync_fused_apply(xa, g, None, E=2, **kw), symsync_fused_reference(xa, g, None, E=2, **kw)]
    assert (symsync_fused_apply.launches, symsync_scan_apply.launches) == (n3, n4)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[1], outs[2]):
        assert torch.equal(a, b)
    for a, b in zip(fused[0], fused[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["rank", "xs4_dtype", "state", "locked", "device", "n_valid"])
def test_scan_apply_rejects_bad_input(bad):
    j, _ = _pair()
    _, _, kw, xa, g = _kernel_args(j, np.random.default_rng(5))
    xs4 = branch_outputs(torch.from_numpy(xa), torch.from_numpy(g))
    n_valid = None
    if bad == "rank":
        xs4 = xs4[0]
    elif bad == "xs4_dtype":
        xs4 = xs4.double()
    elif bad == "state":
        kw["state"] = kw["state"][:8]
    elif bad == "locked":
        kw["locked"] = kw["locked"].float()
    elif bad == "device":
        xs4 = xs4.to("meta")
    else:
        n_valid = torch.tensor(200, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        symsync_scan_apply(xs4, n_valid, E=2, **kw)


@pytest.mark.parametrize("bad", ["g_rows", "xa_dtype", "short", "layout"])
def test_fused_apply_rejects_bad_input(bad):
    j, _ = _pair()
    _, _, kw, xa, g = _kernel_args(j, np.random.default_rng(6))
    xa, g = torch.from_numpy(xa), torch.from_numpy(g)
    if bad == "g_rows":
        g = g[:P]
    elif bad == "xa_dtype":
        xa = xa.to(torch.complex128)
    elif bad == "short":
        xa = xa[:, :L]
    else:
        xa = torch.cat([xa, xa], 1)[:, ::2]
    with pytest.raises((ValueError, TypeError)):
        symsync_fused_apply(xa, g, None, E=2, **kw)


# ------------------------------------------------------------ Symsync
def test_create_matches_yagi_tpu():
    j, t = _pair()
    np.testing.assert_array_equal(t.mf.numpy(), np.asarray(j.mf))
    np.testing.assert_array_equal(t.dmf.numpy(), np.asarray(j.dmf))
    np.testing.assert_array_equal(t.pll_a.numpy(), np.asarray(j.pll_a))
    np.testing.assert_array_equal(t.pll_b.numpy(), np.asarray(j.pll_b))
    np.testing.assert_array_equal(t.rate_adjustment.numpy(), np.asarray(j.rate_adjustment))
    jk = JSymsync.create_kaiser(2, 3, 0.4, num_filters=16, batch_shape=(2,))
    tk = Symsync.create_kaiser(2, 3, 0.4, num_filters=16, batch_shape=(2,), device=DEV)
    np.testing.assert_array_equal(tk.mf.numpy(), np.asarray(jk.mf))
    np.testing.assert_array_equal(tk.dmf.numpy(), np.asarray(jk.dmf))


def _check_slots(yt, vt, yj, vj):
    yj, vj = np.asarray(yj), np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert np.abs(yt.numpy() - yj).max() < SLOT_TOL * max(np.abs(yj).max(), 1.0)


@pytest.mark.parametrize("backend", ["auto", "fused", "pallas", "xla"])
def test_execute_slots_matches_xla_scan_across_blocks(backend):
    """A 128 + 128 split, the second block with n_valid = 100; the port's
    backend against yagi_tpu's XLA scan on the same split."""
    x = _sig(7)
    j, t = _pair()
    for blk, n_valid in ((x[:, :128], None), (x[:, 128:], 100)):
        yj, vj, j = j.execute_slots(jnp.asarray(blk), n_valid=n_valid, backend="xla")
        yt, vt, t = t.execute_slots(torch.from_numpy(blk), n_valid=n_valid, backend=backend)
        _check_slots(yt, vt, yj, vj)
        np.testing.assert_allclose(t.tau.numpy(), np.asarray(j.tau), atol=1e-4)
        np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
        np.testing.assert_array_equal(t.decim_counter.numpy(), np.asarray(j.decim_counter))
        np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))


def test_execute_slots_block_split_is_exact():
    """Against itself the port is bit-invariant to block splits, on every
    backend (the plain versions here; chip_smoke.py checks the kernels)."""
    x = torch.from_numpy(_sig(8))
    for backend in ("auto", "pallas", "xla"):
        _, t = _pair()
        yf, vf, sf = t.execute_slots(x, backend=backend)
        y1, v1, s = t.execute_slots(x[:, :100], backend=backend)
        y2, v2, s = s.execute_slots(x[:, 100:], backend=backend)
        assert torch.equal(torch.cat([v1, v2], 1), vf)
        assert torch.equal(torch.cat([y1, y2], 1), yf)
        assert torch.equal(s.tau, sf.tau) and torch.equal(s.window, sf.window)


def test_execute_compacts_like_yagi_tpu():
    x = _sig(9)
    j, t = _pair()
    yj, kj, j = j.execute(jnp.asarray(x))
    yt, kt, t = t.execute(torch.from_numpy(x))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < SLOT_TOL * max(np.abs(np.asarray(yj)).max(), 1.0)


def test_state_carries_over_from_yagi_tpu():
    """A yagi_tpu Symsync mid-stream loads into the port (its TPU-only
    bank_g dropped) and continues as yagi_tpu does."""
    x = _sig(10)
    j, _ = _pair()
    _, _, j = j.execute_slots(jnp.asarray(x[:, :96]), backend="xla")
    t = load_state(Symsync, j, device=DEV)
    assert t.b.dtype == torch.int32 and t.locked.dtype == torch.bool
    yj, vj, j = j.execute_slots(jnp.asarray(x[:, 96:]), backend="xla")
    yt, vt, t = t.execute_slots(torch.from_numpy(x[:, 96:]), backend="xla")
    _check_slots(yt, vt, yj, vj)
    np.testing.assert_allclose(t.tau.numpy(), np.asarray(j.tau), atol=1e-4)


def test_controls_match_yagi_tpu():
    """lock (no timing updates), set_output_rate, unlock, reset, get_tau."""
    x = _sig(11, c=4)
    j, t = (JSymsync.create_rnyquist(JShape.RRCOS, 2, 7, 0.3, batch_shape=(4,)),
            Symsync.create_rnyquist("rrcos", 2, 7, 0.3, batch_shape=(4,), device=DEV))
    j, t = j.lock(), t.lock()
    yj, vj, j = j.execute_slots(jnp.asarray(x), backend="xla")
    yt, vt, t = t.execute_slots(torch.from_numpy(x), backend="auto")
    _check_slots(yt, vt, yj, vj)
    np.testing.assert_array_equal(t.get_tau().numpy(), np.asarray(j.get_tau()))
    j, t = j.unlock().set_output_rate(2).reset(), t.unlock().set_output_rate(2).reset()
    assert t.k_out == 2 and not t.locked.any() and not t.window.any()
    np.testing.assert_array_equal(t.rate.numpy(), np.asarray(j.rate))
    yj, vj, j = j.execute_slots(jnp.asarray(x), backend="xla")
    yt, vt, t = t.execute_slots(torch.from_numpy(x), backend="pallas")
    assert yt.shape == (4, N, 3)
    _check_slots(yt, vt, yj, vj)


def test_unbatched_and_real_input():
    """batch_shape () and a float32 stream, as yagi_tpu takes them."""
    x = _sig(12, c=1)[0].real.copy()
    j = JSymsync.create_rnyquist(JShape.RRCOS, 2, 7, 0.3, dtype=jnp.float32)
    t = Symsync.create_rnyquist("rrcos", 2, 7, 0.3, dtype=torch.float32, device=DEV)
    yj, vj, _ = j.execute_slots(jnp.asarray(x), backend="xla")
    yt, vt, _ = t.execute_slots(torch.from_numpy(x))
    assert yt.dtype == torch.float32 and yt.shape == (N, 2)
    _check_slots(yt, vt, yj, vj)


@pytest.mark.parametrize(
    "make",
    [lambda t: t.execute_slots(torch.zeros(C, 10, dtype=torch.complex64), samples_per_step=3),
     lambda t: t.execute_slots(torch.zeros(C, 8, dtype=torch.complex64), backend="mosaic"),
     lambda t: t.set_lf_bw(1.5), lambda t: t.set_output_rate(0),
     lambda t: Symsync.create_rnyquist("rrcos", 1, 7, 0.3, device=DEV),
     lambda t: Symsync.create_rnyquist("nyquist", 2, 7, 0.3, device=DEV),
     # gmsktx designs now (tests/test_torch_design_l3.py); its beta out of range does not
     lambda t: Symsync.create_rnyquist("gmsktx", 2, 7, 1.5, device=DEV)],
)
def test_rejects_bad_config(make):
    _, t = _pair()
    with pytest.raises(ConfigError):
        make(t)


def test_samples_per_step_changes_nothing():
    x = torch.from_numpy(_sig(13))
    _, t = _pair()
    y1, v1, _ = t.execute_slots(x)
    y4, v4, _ = t.execute_slots(x, samples_per_step=4)
    assert torch.equal(y1, y4) and torch.equal(v1, v4)


# ------------------------------------------------------- deferral count
def _deferring(c=C, k_out=2, rate=0.5):
    """A yagi_tpu Symsync and its port with rate and δ at 0.5, half of
    nominal for k_out = 2 (a quarter for k_out = 1): ~2 emissions are due per
    input sample, so two slots leave one due after some samples (at 0.48 and
    below, after every sample)."""
    j, _ = _pair(c, k_out=k_out)
    j = j.replace(rate=jnp.full((c,), rate, jnp.float32), delta=jnp.full((c,), rate, jnp.float32))
    return j, load_state(Symsync, j, device=DEV)


@pytest.mark.parametrize("k_out", [1, 2])
def test_deferral_count_equal_across_routes(k_out):
    """K3's and K4's plain versions and the XLA-form scan count the same
    deferrals, bit for bit, on a deferring state."""
    j, t = _deferring(k_out=k_out)
    _, _, _, xa, g = _kernel_args(j, np.random.default_rng(14))
    xa, g = torch.from_numpy(xa), torch.from_numpy(g)
    kw = dict(E=2, **t.kernel_args())
    xs4 = branch_outputs(xa, g)
    counts = [symsync_fused_reference(xa, g, None, **kw)[3],
              symsync_scan_reference(xs4, None, **kw)[3], symsync_scan_xla(xs4, None, **kw)[3]]
    assert counts[0].dtype == torch.int32 and counts[0].shape == (C,)
    assert counts[0].max() > 0 and counts[0].min() < N
    for other in counts[1:]:
        assert torch.equal(other, counts[0])


def test_deferral_count_matches_yagi_emit_sample():
    """The count equals yagi_tpu's ``pending`` summed over the block
    (``filter/symsync.py::_emit_sample``, the flag QamRx's fused route adds to
    overflow_count), at k_out = 2 and two slots, as QamRx runs it."""
    import jax

    from yagi_tpu.filter.symsync import _emit_sample, _sym_carry, _sym_loop_params

    j, t = _deferring()
    x = _sig(15)
    xs4, _ = j.branch_outputs_4xP(jnp.asarray(x))
    params = _sym_loop_params(j)

    def body(carry, x4):
        carry, _, pending = _emit_sample(params, carry, x4, 2, jnp.float32(j.k))
        return carry, pending.astype(jnp.int32)

    _, pend = jax.lax.scan(body, _sym_carry(j), xs4)
    _, _, _, deferred = t._run_slots(torch.from_numpy(x), max_emit=2)
    np.testing.assert_array_equal(deferred.numpy(), np.asarray(pend).sum(0))
    assert deferred.max() > 0 and deferred.min() < N


def test_deferral_count_is_zero_on_config1_path():
    """config[1]'s Symsync (k_out = 1, two slots, nominal rate 2) never
    defers on random input: the count is 0 on every route, and
    execute_slots keeps its three results."""
    x = torch.from_numpy(_sig(16))
    _, t = _pair()
    for backend in ("auto", "pallas", "xla"):
        y, v, s, deferred = t._run_slots(x, backend=backend)
        assert deferred.shape == (C,) and not deferred.any()
        assert len(t.execute_slots(x, backend=backend)) == 3


# ------------------------------------------- banks past K3's shared memory
def test_fused_smem_mirror_and_gate():
    """The Python mirror of csrc/symscan.cu::fused_layout: config[1]'s bank
    takes 41,536 bytes, and the card's 232,448 are passed at L = 173 for 64
    filters and at L = 325 for 32."""
    assert fused_smem_bytes(28, 32) == 41536
    assert fused_fits(28, 32) and fused_fits(172, 64) and not fused_fits(173, 64)
    assert fused_fits(324, 32) and not fused_fits(325, 32)
    assert fused_smem_bytes(176, 64) > FUSED_SMEM_LIMIT == 232448


# K4's staged layout: (chans, w, bytes) = 2·chans·w·(16P + 9E) bytes (two
# tiles: the loop's and the next); 8 channels and up to 32 rows a tile, fewer
# rows as P grows, fewer channels past one row of 8, the direct instance past
# one row of one (P > 7262 at E = 2)
@pytest.mark.parametrize("P, E, want", [
    (32, 2, (8, 27, 228960)),  # config[1]
    (64, 2, (8, 13, 216736)),  # the gate bank
    (256, 2, (8, 3, 197472)),
    (768, 2, (8, 1, 196896)),
    (1024, 2, (7, 1, 229628)),
    (7262, 2, (1, 1, 232420)),
    (7263, 2, None),
    (4, 1, (8, 32, 37376)),
])
def test_scan_layout_mirror(P, E, want):
    got = scan_layout(P, E)
    assert got == want
    if got is not None:
        chans, w, nbytes = got
        assert nbytes == 2 * chans * w * (16 * P + 9 * E) <= FUSED_SMEM_LIMIT


def _big_pair(c=3):
    """64 filters, k = 4, m = 22: L = 176 taps a branch, past K3's limit."""
    j = JSymsync.create_rnyquist(JShape.RRCOS, 4, 22, 0.3, 64, batch_shape=(c,)).set_lf_bw(0.02)
    t = Symsync.create_rnyquist("rrcos", 4, 22, 0.3, 64, batch_shape=(c,),
                                device=DEV).set_lf_bw(0.02)
    return j, t


def test_auto_past_the_fused_limit_matches_yagi_tpu(monkeypatch):
    """"auto" hands a bank that K3 cannot stage to K4's route (by its shape,
    before any launch), as yagi_tpu's "auto" routes such shapes away."""
    j, t = _big_pair()
    assert t.mf.shape == (64, 176) and not fused_fits(176, 64)
    routes = []
    import yagi_tpu_torch.filter.symsync as mod

    real = mod.symsync_scan_apply
    monkeypatch.setattr(mod, "symsync_scan_apply",
                        lambda *a, **k: routes.append("scan") or real(*a, **k))
    monkeypatch.setattr(mod, "symsync_fused_apply",
                        lambda *a, **k: pytest.fail("K3's wrapper called past its limit"))
    x = _sig(11, c=3)
    yj, vj, j = j.execute_slots(jnp.asarray(x), backend="auto")
    yt, vt, t = t.execute_slots(torch.from_numpy(x), backend="auto")
    assert routes == ["scan"]
    _check_slots(yt, vt, yj, vj)
    np.testing.assert_allclose(t.tau.numpy(), np.asarray(j.tau), atol=1e-4)
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
    np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))


def test_fused_past_the_limit_raises_config_error(monkeypatch):
    """backend="fused" names L, P and the limit before any launch, on any
    device; the kernel's wrapper refuses the shape too (the card hidden: the
    gate is arithmetic on the shape)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t = _big_pair()
    with pytest.raises(ConfigError, match="L = 176.*P = 64.*232448"):
        t.execute_slots(torch.from_numpy(_sig(12, c=3)), backend="fused")
    # the same bank on "pallas" and "xla" runs, and the two agree bit for bit
    x = torch.from_numpy(_sig(12, c=3, n=64))
    a, b = t.execute_slots(x, backend="pallas"), t.execute_slots(x, backend="xla")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
