"""yagi_tpu_torch.optim and .buffer against yagi_tpu on the CPU.

The searches (GradSearch, QnSearch, GaSearch with the same seed, Qs1dSearch
over the reference's qs1dsearch scenarios) follow yagi_tpu's iterates
within 1e-12 relative; Chromosome's operations and the buffers (Window,
WDelay, CBuffer under tests/test_buffer_bitsync.py:22-146's operation
sequences) are exact, errors included. Each host object also takes over a
driven yagi_tpu object's state through its public accessors and then
follows it.
"""

import numpy as np
import pytest
import torch

import yagi_tpu.buffer as jb
import yagi_tpu.optim as jo
import yagi_tpu_torch.buffer as tb
import yagi_tpu_torch.optim as to
from yagi_tpu_torch.errors import ConfigError, NoConvergenceError, ValueRangeError

torch.set_num_threads(1)

RTOL = 1e-12


def _direction(mod, name):
    return getattr(mod.OptimDirection, name)


def _quad(v):
    return float(np.sum((np.asarray(v) - np.array([0.3, -1.2, 2.0])[: len(v)]) ** 2))


def _rosen(v):
    return float((1 - v[0]) ** 2 + 100 * (v[1] - v[0] ** 2) ** 2)


@pytest.mark.parametrize("direction", ["MINIMIZE", "MAXIMIZE"])
def test_gradsearch_iterates(direction):
    sign = 1.0 if direction == "MINIMIZE" else -1.0
    u = lambda v: sign * _quad(v)  # noqa: E731
    t = to.GradSearch(u, [1.0, 1.0, 1.0], _direction(to, direction), gamma=0.05)
    j = jo.GradSearch(u, [1.0, 1.0, 1.0], _direction(jo, direction), gamma=0.05)
    for _ in range(60):
        np.testing.assert_allclose(t.step(), j.step(), rtol=RTOL, atol=0)
        np.testing.assert_allclose(t.v, j.v, rtol=RTOL, atol=0)
        assert t.gamma == j.gamma
    np.testing.assert_allclose(t.execute(200), j.execute(200), rtol=RTOL, atol=0)
    assert t.num_steps == j.num_steps
    with pytest.raises(ConfigError):
        to.GradSearch(u, [0.0], delta=0.0)


@pytest.mark.parametrize("direction", ["MINIMIZE", "MAXIMIZE"])
def test_qnsearch_iterates(direction):
    sign = 1.0 if direction == "MINIMIZE" else -1.0
    u = lambda v: sign * _rosen(v)  # noqa: E731
    t = to.QnSearch(u, [-1.2, 1.0], _direction(to, direction))
    j = jo.QnSearch(u, [-1.2, 1.0], _direction(jo, direction))
    for _ in range(40):
        np.testing.assert_allclose(t.step(), j.step(), rtol=RTOL, atol=0)
        np.testing.assert_allclose(t.v, j.v, rtol=RTOL, atol=0)
        np.testing.assert_allclose(t.B, j.B, rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(t.execute(), j.execute(), rtol=RTOL, atol=0)
    with pytest.raises(ConfigError):
        to.QnSearch(u, [0.0, 0.0], delta=-1.0)


def _chrom_state(c):
    return [c.value(i) for i in range(c.num_traits)]


@pytest.mark.parametrize("direction,seed", [("MAXIMIZE", 1), ("MINIMIZE", 3)])
def test_gasearch_same_draws(direction, seed):
    def u(c):
        return -((c.valuef(0) - 0.3) ** 2) - (c.valuef(1) - 0.6) ** 2

    t = to.GaSearch(u, to.Chromosome([12, 9]), _direction(to, direction), population_size=16,
                    mutation_rate=0.2, seed=seed)
    j = jo.GaSearch(u, jo.Chromosome([12, 9]), _direction(jo, direction), population_size=16,
                    mutation_rate=0.2, seed=seed)
    for _ in range(15):
        np.testing.assert_allclose(t.evolve(), j.evolve(), rtol=RTOL, atol=0)
        assert [_chrom_state(c) for c in t.population] == [_chrom_state(c) for c in j.population]
    assert t.num_generations == j.num_generations == 15
    assert _chrom_state(t.run(5)) == _chrom_state(j.run(5))
    with pytest.raises(ConfigError):
        to.GaSearch(u, to.Chromosome([4]), population_size=2)
    with pytest.raises(ConfigError):
        to.GaSearch(u, to.Chromosome([4]), mutation_rate=1.5)


def test_chromosome_ops_and_state():
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    t, j = to.Chromosome([5, 13, 64, 1]), jo.Chromosome([5, 13, 64, 1])
    t.init_random(rng_t)
    j.init_random(rng_j)
    assert _chrom_state(t) == _chrom_state(j)
    assert [t.valuef(i) for i in range(4)] == [j.valuef(i) for i in range(4)]
    for bit in (0, 4, 5, 17, 50, 82):
        t.mutate(bit)
        j.mutate(bit)
        assert _chrom_state(t) == _chrom_state(j)
    other_t, other_j = to.Chromosome.create_basic(1, 5), jo.Chromosome.create_basic(1, 5)
    assert (other_t.num_traits, other_t.num_bits) == (other_j.num_traits, other_j.num_bits)
    u_t, u_j = to.Chromosome([5, 13, 64, 1]), jo.Chromosome([5, 13, 64, 1])
    u_t.init_random(rng_t)
    u_j.init_random(rng_j)
    for thr in (0, 3, 5, 11, 18, 40, 83):
        assert _chrom_state(t.crossover(u_t, thr)) == _chrom_state(j.crossover(u_j, thr))
    # the state carried over through the public accessors: valuef, set_valuef
    c = to.Chromosome([5, 13, 20, 1])
    jc = jo.Chromosome([5, 13, 20, 1])
    jc.init_random(np.random.default_rng(2))
    for i in range(4):
        c.set_valuef(i, jc.valuef(i))
    assert _chrom_state(c) == _chrom_state(jc)
    c.mutate(7)
    jc.mutate(7)
    assert _chrom_state(c) == _chrom_state(jc)
    for bad in ([], [0], [65]):
        with pytest.raises(ConfigError):
            to.Chromosome(bad)
    with pytest.raises(ConfigError):
        t.mutate(t.num_bits)
    with pytest.raises(ConfigError):
        t.crossover(to.Chromosome([5]), 1)


# the reference's qs1dsearch scenarios (tests/test_utility_optim.py:275-288)
_SCEN = {"01": (-40.0, 0.0, False), "03": (-4.0, 0.0, False), "05": (0.0, 0.0, False),
         "07": (20.0, 0.0, False), "10": (-30.0, 15.0, True), "13": (-0.1, 15.0, True)}


@pytest.mark.parametrize("direction", ["MINIMIZE", "MAXIMIZE"])
@pytest.mark.parametrize("sid", sorted(_SCEN))
def test_qs1dsearch_iterates(direction, sid):
    lo, hi, bounded = _SCEN[sid]
    sign = 1.0 if direction == "MINIMIZE" else -1.0
    u = lambda v: sign * float(np.tanh(v) ** 2)  # noqa: E731
    t = to.Qs1dSearch(u, _direction(to, direction))
    j = jo.Qs1dSearch(u, _direction(jo, direction))
    if bounded:
        t.init_bounds(lo, hi)
        j.init_bounds(lo, hi)
    else:
        t.init(lo)
        j.init(lo)
    for _ in range(32):
        t.step()
        j.step()
        got = (t.vn, t.v0, t.vp, t.un, t.u0, t.up)
        np.testing.assert_allclose(got, (j.vn, j.v0, j.vp, j.un, j.u0, j.up), rtol=RTOL, atol=0)
    t.execute()
    assert t.get_num_steps() == j.get_num_steps() == 32
    assert t.get_opt_v() == pytest.approx(0.0, abs=1e-3)
    assert (t.get_opt_v(), t.get_opt_u()) == (j.get_opt_v(), j.get_opt_u())
    t.reset()
    assert not t.initialized and t.get_num_steps() == 0
    with pytest.raises(ConfigError):
        t.step()


def test_qs1dsearch_no_convergence():
    t = to.Qs1dSearch(lambda v: 1.0)  # flat: no bracket in either direction
    with pytest.raises(NoConvergenceError):
        t.init(0.0)


# ------------------------------------------------------------------- buffers
def _window_ops(mod):
    """tests/test_buffer_bitsync.py:24-50's sequence; every read."""
    w = mod.Window(10)
    reads = [w.read()]
    for _ in range(4):
        w.push(1.0)
    reads.append(w.read())
    w.write([9.0, 8.0, 7.0, 6.0])
    reads.append(w.read())
    for _ in range(4):
        w.push(3.0)
    reads += [w.read(), np.array([w.index(0), w.index(2), w.index(9)])]
    for _ in range(4):
        w.push(5.0)
    reads.append(w.read())
    w.resize(6)
    reads.append(w.read())
    w.push(6.0)
    w.push(7.0)
    reads.append(w.read())
    w.resize(10)
    reads.append(w.read())
    w.reset()
    reads.append(w.read())
    return reads


def test_window_sequence_exact():
    for a, b in zip(_window_ops(tb), _window_ops(jb), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueRangeError):
        tb.Window(4).index(4)
    with pytest.raises(ConfigError):
        tb.Window(0)
    with pytest.raises(ConfigError):
        tb.Window(3).resize(0)
    # a returned read is a copy
    w = tb.Window(3)
    r = w.read()
    r[:] = 7
    assert not w.read().any()


def test_window_state_carried_over():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(40) + 1j * rng.standard_normal(40)).astype(np.complex64)
    j = jb.Window(7, dtype=np.complex64)
    j.write(x[:20])
    t = tb.Window(7, dtype=np.complex64)
    t.write(j.read())
    for v in x[20:]:
        t.push(v)
        j.push(v)
        np.testing.assert_array_equal(t.read(), j.read())


def test_wdelay_sequence_exact():
    t, j = tb.WDelay(3), jb.WDelay(3)
    outs = []
    for x in range(1, 9):
        t.push(float(x))
        j.push(float(x))
        outs.append((t.read(), j.read()))
    assert [a for a, _ in outs] == [b for _, b in outs] == [0, 0, 0, 1, 2, 3, 4, 5]
    for d in (4, 4, 2, 6):
        t.recreate(d)
        j.recreate(d)
        seq = []
        for x in (10.0, 11.0, 12.0, 13.0):
            seq.append((t.read(), j.read()))
            t.push(x)
            j.push(x)
        assert [a for a, _ in seq] == [b for _, b in seq]
    t.reset()
    assert t.read() == 0
    with pytest.raises(ConfigError):
        tb.WDelay(0)


def test_wdelay_state_carried_over():
    """WDelay has no history accessor: the port's line is primed with the
    last ``delay`` inputs yagi_tpu's took, then both follow one stream."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(50).astype(np.float32)
    j = jb.WDelay(5)
    for v in x[:30]:
        j.push(v)
    t = tb.WDelay(5)
    for v in x[30 - 6 : 30]:
        t.push(v)
    assert t.read() == j.read()
    for v in x[30:]:
        t.push(v)
        j.push(v)
        assert t.read() == j.read()


def _cbuffer_ops(mod):
    """tests/test_buffer_bitsync.py:102-146's sequences; every observation,
    each error as its class name."""
    out = []

    def err(fn, *a):
        try:
            fn(*a)
        except Exception as e:  # noqa: BLE001 - recorded by name and compared
            out.append(type(e).__name__)

    cb = mod.CBuffer(10)
    cb.write([1, 2, 3, 4])
    out += [cb.size(), cb.read(4).tolist()]
    cb.release(2)
    out.append(cb.size())
    cb.write(np.arange(5, 13))
    out += [cb.is_full(), cb.read(10).tolist(), cb.space_available()]
    err(cb.push, 99)
    out.append(float(cb.pop()))
    cb.push(13)
    out += [cb.read(10).tolist(), cb.read(0).tolist(), cb.read(30).tolist()]
    err(cb.read, -1)
    cb2 = mod.CBuffer(4)
    err(cb2.release, 1)
    err(cb2.pop)
    err(cb2.write, [1, 2, 3, 4, 5])
    cb2.reset()
    out.append(cb2.size())
    err(mod.CBuffer, 0)
    return out


def test_cbuffer_sequence_exact():
    got, want = _cbuffer_ops(tb), _cbuffer_ops(jb)
    assert got == want
    assert got.count("ValueRangeError") == 5 and got.count("ConfigError") == 1


def test_cbuffer_state_carried_over():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(64).astype(np.float32)
    j = jb.CBuffer(16)
    j.write(x[:12])
    j.release(5)
    t = tb.CBuffer(16)
    t.write(j.read(j.size()))
    for k in range(12, 64, 4):
        t.write(x[k : k + 4])
        j.write(x[k : k + 4])
        np.testing.assert_array_equal(t.read(t.size()), j.read(j.size()))
        assert t.pop() == j.pop()
        t.release(3)
        j.release(3)
        assert t.size() == j.size()
