"""yagi_tpu_torch's MsResamp (with Resamp2, MsResamp2 and Resamp's
valid-prefix form), compact_valid, and the whole config[1] slice
(MsResamp → Symsync) against yagi_tpu.

* MsResamp at 2/2.0663 (config[1]'s rate, ``arbitrary_interp="farrow"``,
  which at a rate below 1 runs the PFB gather of ``Resamp.execute_block_n``),
  at 0.3 (one halfband decimator and a carry) and at 3.0 (``"pfb"``, one
  halfband interpolator): 3 carried blocks of 512 at C = 16, counts, carry
  and u32 phase exact, values within 1e-5·max(1, |y|) (float32 sums in
  another order).
* The slice at C = 128: masks equal, values < 1e-4·max(|y|, 1), the
  tolerance of tests/test_symscan.py's fused-kernel test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.design import FirFilterShape as JShape
from yagi_tpu.filter import MsResamp as JMsResamp
from yagi_tpu.filter import Resamp as JResamp
from yagi_tpu.filter import Symsync as JSymsync
from yagi_tpu.utils.compact import compact_valid as j_compact
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.filter import MsResamp, Resamp, Symsync
from yagi_tpu_torch.utils import compact_valid

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

RATE1 = 2.0 / 2.0663  # config[1] (bench.py:179)
TOL = 1e-5
SLOT_TOL = 1e-4


def _sig(seed, c, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))).astype(np.complex64)


def _close(yt, yj, tol):
    yj = np.asarray(yj)
    assert yt.shape == yj.shape
    assert np.abs(yt.numpy() - yj).max() <= tol * max(1.0, np.abs(yj).max())


def _check_state(t, j):
    assert int(t.carry_len) == int(np.asarray(j.carry_len))
    np.testing.assert_array_equal(t.carry.numpy(), np.asarray(j.carry))
    assert int(t.arbitrary.phase) == int(np.asarray(j.arbitrary.phase))
    # the arbitrary stage's window holds halfband outputs when k > 0
    np.testing.assert_allclose(t.arbitrary.window.numpy(), np.asarray(j.arbitrary.window),
                               rtol=0, atol=TOL)
    for st, sj in zip(t.halfband.stages, j.halfband.stages):
        np.testing.assert_allclose(st.w0.numpy(), np.asarray(sj.w0), rtol=0, atol=TOL)
        np.testing.assert_allclose(st.w1.numpy(), np.asarray(sj.w1), rtol=0, atol=TOL)


_RATES = [(RATE1, "farrow"), (0.3, "pfb"), (3.0, "pfb")]


@pytest.mark.parametrize("rate, interp", _RATES)
def test_msresamp_matches_yagi_tpu_across_blocks(rate, interp):
    x = _sig(1, 16, 3 * 512)
    j = JMsResamp.create(rate, batch_shape=(16,), arbitrary_interp=interp)
    t = MsResamp.create(rate, batch_shape=(16,), arbitrary_interp=interp, device=DEV)
    assert t.num_halfband_stages == j.num_halfband_stages
    assert t.out_capacity(512) == j.out_capacity(512)
    for st, sj in zip(t.halfband.stages, j.halfband.stages):
        np.testing.assert_array_equal(st.h1.numpy(), np.asarray(sj.h1))
    for i in range(3):
        blk = x[:, i * 512 : (i + 1) * 512]
        assert t.get_num_output(512) == j.get_num_output(512)
        yj, kj, j = j.execute_block(jnp.asarray(blk))
        yt, kt, t = t.execute_block(torch.from_numpy(blk))
        assert kt.dim() == 0 and int(kt) == int(np.asarray(kj))
        _close(yt, yj, TOL)
        _check_state(t, j)


@pytest.mark.parametrize("rate, interp", _RATES)
def test_msresamp_state_carries_over_from_yagi_tpu(rate, interp):
    """load_state takes a yagi_tpu MsResamp whole (its Resamp, MsResamp2 and
    Resamp2 stages) mid-stream; the port continues exactly as it does."""
    x = _sig(2, 4, 700)
    j = JMsResamp.create(rate, batch_shape=(4,), arbitrary_interp=interp)
    _, _, j = j.execute_block(jnp.asarray(x[:, :333]))
    t = load_state(MsResamp, j, device=DEV)
    assert t.arbitrary.interp == interp and len(t.halfband.stages) == j.num_halfband_stages
    yj, kj, j = j.execute_block(jnp.asarray(x[:, 333:]))
    yt, kt, t = t.execute_block(torch.from_numpy(x[:, 333:]))
    assert int(kt) == int(np.asarray(kj))
    _close(yt, yj, TOL)
    _check_state(t, j)


def test_msresamp_execute_compacts():
    x = _sig(3, 2, 300)
    j = JMsResamp.create(0.3, batch_shape=(2,))
    t = MsResamp.create(0.3, batch_shape=(2,), device=DEV)
    yj, _ = j.execute(jnp.asarray(x))
    yt, _ = t.execute(torch.from_numpy(x))
    _close(yt, yj, TOL)


@pytest.mark.parametrize("n_valid", [0, 1, 250, 400])
def test_resamp_execute_block_n_matches_yagi_tpu(n_valid):
    """The valid-prefix form from a nonzero phase, n_valid a device tensor."""
    x = _sig(4, 3, 400)
    j = JResamp.create(RATE1, batch_shape=(3,))
    _, _, j = j.execute_block(jnp.asarray(x[:, :37]))
    t = load_state(Resamp, j, device=DEV)
    yj, kj, j = j.execute_block_n(jnp.asarray(x), n_valid)
    yt, kt, t = t.execute_block_n(torch.from_numpy(x), torch.tensor(n_valid))
    assert int(kt) == int(np.asarray(kj)) and t.exact_sched is None
    _close(yt, yj, TOL)
    assert int(t.phase) == int(np.asarray(j.phase))
    np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))


def test_resamp_farrow_is_stored_but_execute_block_raises():
    """``interp="farrow"`` is stored, and execute_block no longer raises: it
    runs the Farrow values. A Resamp at config[1]'s rate and an
    interpolating MsResamp at 1.5 equal yagi_tpu's farrow outputs, counts
    exact, values within 1e-4 of max |y| (tests/test_torch_farrow.py holds
    the Farrow values in full)."""
    x = _sig(9, 2, 256)
    pairs = ((JResamp.create(RATE1, interp="farrow", batch_shape=(2,)),
              Resamp.create(RATE1, interp="farrow", batch_shape=(2,), device=DEV)),
             (JMsResamp.create(1.5, batch_shape=(2,), arbitrary_interp="farrow"),
              MsResamp.create(1.5, batch_shape=(2,), arbitrary_interp="farrow", device=DEV)))
    for j, t in pairs:
        assert t.interp == "farrow" if isinstance(t, Resamp) else t.arbitrary.interp == "farrow"
        yj, kj, j = j.execute_block(jnp.asarray(x))
        yt, kt, t = t.execute_block(torch.from_numpy(x))
        assert int(kt) == int(kj)
        _close(yt, yj, 1e-4)


@pytest.mark.parametrize("kind", ["complex", "real", "int"])
def test_compact_valid_bit_identical(kind):
    rng = np.random.default_rng(5)
    v = rng.random((6, 300)) < 0.4
    if kind == "complex":
        y = _sig(6, 6, 300)
    elif kind == "real":
        y = rng.standard_normal((6, 300)).astype(np.float32)
    else:
        y = rng.integers(-100, 100, (6, 300)).astype(np.int32)
    yj, kj = j_compact(jnp.asarray(y), jnp.asarray(v))
    yt, kt = compact_valid(torch.from_numpy(y), torch.from_numpy(v))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


def _slice_pair(c):
    jm = JMsResamp.create(RATE1, batch_shape=(c,), arbitrary_interp="farrow")
    tm = MsResamp.create(RATE1, batch_shape=(c,), arbitrary_interp="farrow", device=DEV)
    js = JSymsync.create_rnyquist(JShape.RRCOS, 2, 7, 0.3, batch_shape=(c,)).set_lf_bw(0.02)
    ts = Symsync.create_rnyquist("rrcos", 2, 7, 0.3, batch_shape=(c,), device=DEV).set_lf_bw(0.02)
    return jm, js, tm, ts


def test_slice_msresamp_symsync_matches_yagi_tpu():
    """config[1]'s step, y, cnt = ms.execute_block(x); ss.execute_slots(y,
    n_valid=cnt), over two blocks at C = 128 against yagi_tpu, each on its
    default route: the port's "auto" (K3's plain version on CPU) against
    yagi_tpu's "auto", the XLA scan off the TPU."""
    x = _sig(7, 128, 2 * 256)
    jm, js, tm, ts = _slice_pair(128)
    for i in range(2):
        blk = x[:, i * 256 : (i + 1) * 256]
        yj, kj, jm = jm.execute_block(jnp.asarray(blk))
        sj, vj, js = js.execute_slots(yj, n_valid=kj)
        yt, kt, tm = tm.execute_block(torch.from_numpy(blk))
        st, vt, ts = ts.execute_slots(yt, n_valid=kt)
        assert int(kt) == int(np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        _close(st, sj, SLOT_TOL)
        np.testing.assert_allclose(ts.tau.numpy(), np.asarray(js.tau), atol=1e-4)
