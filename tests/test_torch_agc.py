"""yagi_tpu_torch's Agc and the plain version of its loop kernel against
yagi_tpu's Agc (agc/agc.py), on the CPU.

The gain loop runs expf/logf per sample; XLA's CPU backend has its own exp
and log and contracts a·b + c into an FMA, while the port rounds every op
as the CUDA kernel does, so gains and outputs differ by ulps: they are held
to a relative 1e-5 (the loop is contracting, so the difference does not
grow; measured up to 2.1e-6, in the bandwidth-0.25 squelch walk after a
40 dB step, elsewhere below 1e-6). Squelch modes and timers, which take discrete
steps, are equal. Against itself the port is bit-exact across block splits.
The CUDA kernel runs only on a GPU; chip_smoke.py holds it against
``agc_scan_reference`` bit for bit there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yagi_tpu.agc import Agc as JAgc
from yagi_tpu_torch._src.struct import load_state
from yagi_tpu_torch.agc import Agc, AgcSquelchMode
from yagi_tpu_torch.errors import ConfigError
from yagi_tpu_torch.kernels.agc import agc_scan_apply, agc_scan_reference

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU

REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


def _same_state(t, j, rel=REL):
    _close(t.g.numpy(), j.g, rel)
    _close(t.y2_prime.numpy(), j.y2_prime, rel)
    np.testing.assert_array_equal(t.squelch_mode.numpy(), np.asarray(j.squelch_mode))
    np.testing.assert_array_equal(t.squelch_timer.numpy(), np.asarray(j.squelch_timer))


def _noise(seed, shape, scale=1.0, real=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if not real:
        x = x + 1j * rng.standard_normal(shape)
    return (scale * x).astype(np.float32 if real else np.complex64)


@pytest.mark.parametrize("real", [False, True])
def test_execute_block_matches_yagi_tpu(real):
    """Four channels at different levels, two blocks, bandwidth 0.05."""
    x = _noise(1, (4, 600), real=real) * np.array([[0.01], [0.3], [1.0], [20.0]], np.float32)
    j = JAgc.create(bandwidth=0.05, batch_shape=(4,))
    t = Agc.create(bandwidth=0.05, batch_shape=(4,), device=DEV)
    for blk in np.split(x, [250], axis=-1):
        yj, j = j.execute_block(jnp.asarray(blk))
        yt, t = t.execute_block(torch.from_numpy(blk))
        assert yt.dtype == (torch.float32 if real else torch.complex64)
        _close(yt.numpy(), yj)
        _same_state(t, j)


def test_reference_matches_yagi_scan_and_wrapper_runs_it_on_cpu():
    """``agc_scan_reference`` fed yagi_tpu's state equals yagi_tpu's scan;
    the wrapper runs it on CPU tensors, bit for bit, with no launch."""
    x = _noise(2, (3, 400), 0.2)
    j = JAgc.create(bandwidth=0.02, batch_shape=(3,)).squelch_enable().squelch_set_threshold(-10.0)
    t = load_state(Agc, j, device=DEV)
    args = (torch.from_numpy(x), t.g, t.y2_prime, t.alpha, t.scale, t.squelch_threshold, t.locked,
            t.squelch_mode, t.squelch_timer)
    launches = agc_scan_apply.launches
    ref = agc_scan_reference(*args, timeout=100)
    out = agc_scan_apply(*args, timeout=100)
    assert agc_scan_apply.launches == launches
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    yj, j = j.execute_block(jnp.asarray(x))
    _close(ref[0].numpy(), yj)
    _close(ref[1].numpy(), j.g)
    np.testing.assert_array_equal(ref[3].numpy(), np.asarray(j.squelch_mode))
    np.testing.assert_array_equal(ref[4].numpy(), np.asarray(j.squelch_timer))


def test_dc_level_locks_to_unity():
    """tests/test_modem.py TestAgc: a DC level of 0.1 at bandwidth 0.1."""
    x = np.full(256, 0.1 + 0j, dtype=np.complex64)
    yt, t = Agc.create(bandwidth=0.1, device=DEV).execute_block(torch.from_numpy(x))
    yj, j = JAgc.create(bandwidth=0.1).execute_block(jnp.asarray(x))
    assert abs(complex(yt[-1]) - 1.0) < 1e-3
    assert float(t.get_gain()) == pytest.approx(10.0, abs=1e-2)
    _close(yt.numpy(), yj)
    _same_state(t, j)


def test_squelch_scenario_matches_yagi_tpu():
    """The reference squelch scenario (tests/test_modem.py:400-460): a
    tapered level crossing −50 dB, the FSM read at the reference's sample
    indices, the state equal to yagi_tpu's at each."""
    i = np.arange(2000)
    gamma = np.full(2000, 1e-3)
    r = (i >= 500) & (i < 550)
    gamma[r] = 1e-3 + (1e-2 - 1e-3) * (0.5 - 0.5 * np.cos(np.pi * (i[r] - 500) / 50.0))
    gamma[(i >= 550) & (i < 1450)] = 1e-2
    f = (i >= 1450) & (i < 1500)
    gamma[f] = 1e-3 + (1e-2 - 1e-3) * (0.5 + 0.5 * np.cos(np.pi * (i[f] - 1450) / 50.0))
    x = (gamma * np.exp(2j * np.pi * 0.0193 * i)).astype(np.complex64)

    def setup(a, **kw):
        return (a.create(bandwidth=0.25, **kw).set_signal_level(1e-3).squelch_enable()
                .squelch_set_threshold(-50.0).squelch_set_timeout(100))

    t, j = setup(Agc, device=DEV), setup(JAgc)
    assert bool(t.squelch_is_enabled()) and t.squelch_get_timeout() == 100
    expect = {0: AgcSquelchMode.ENABLED, 500: AgcSquelchMode.ENABLED,
              600: AgcSquelchMode.SIGNAL_HI, 1400: AgcSquelchMode.SIGNAL_HI,
              1500: AgcSquelchMode.SIGNAL_LO, 1600: AgcSquelchMode.ENABLED,
              1900: AgcSquelchMode.ENABLED}
    start = 0
    for stop in sorted(k + 1 for k in expect):
        _, t = t.execute_block(torch.from_numpy(x[start:stop]))
        _, j = j.execute_block(jnp.asarray(x[start:stop]))
        start = stop
        assert int(t.squelch_get_status()) == expect[stop - 1], stop - 1
        _same_state(t, j)


def test_squelch_timeout_path():
    """Rise on a strong signal, then fall through SIGNAL_LO to TIMEOUT and
    back to ENABLED on silence (tests/test_modem.py:440): the port one sample
    at a time, its state against yagi_tpu's every five samples."""
    def setup(a, **kw):
        return a.create(bandwidth=0.25, **kw).squelch_enable().squelch_set_threshold(0.0) \
            .set_rssi(-40.0).squelch_set_timeout(5)

    t, j = setup(Agc, device=DEV), setup(JAgc)
    x = np.concatenate([np.full(40, 1.0), np.full(60, 1e-4)]).astype(np.complex64)
    seen = set()
    for blk in np.split(x, 20):
        for v in blk:
            _, t = t.execute(torch.tensor(v))
            seen.add(int(t.squelch_mode))
        _, j = j.execute_block(jnp.asarray(blk))
        _same_state(t, j)
    assert {AgcSquelchMode.RISE, AgcSquelchMode.SIGNAL_HI, AgcSquelchMode.FALL,
            AgcSquelchMode.SIGNAL_LO, AgcSquelchMode.TIMEOUT} <= seen


def test_block_split_is_exact():
    x = torch.from_numpy(_noise(8, (2, 400), 0.05))
    t = Agc.create(batch_shape=(2,), device=DEV).squelch_enable()
    y1, s1 = t.execute_block(x)
    parts, s2 = [], t
    for c in torch.split(x, [100, 1, 199, 100], dim=-1):
        y, s2 = s2.execute_block(c, samples_per_step=c.shape[-1] if c.shape[-1] < 200 else 1)
        parts.append(y)
    assert torch.equal(torch.cat(parts, -1), y1)
    for f in ("g", "y2_prime", "squelch_mode", "squelch_timer"):
        assert torch.equal(getattr(s1, f), getattr(s2, f))


def test_controls_match_yagi_tpu():
    """lock (no tracking), scale, set_gain, set_rssi, init, reset."""
    x = _noise(3, (2, 64), 0.1)
    t = Agc.create(bandwidth=0.1, batch_shape=(2,), device=DEV)
    j = JAgc.create(bandwidth=0.1, batch_shape=(2,))
    t, j = t.set_scale(4.0).set_rssi(0.0).lock(), j.set_scale(4.0).set_rssi(0.0).lock()
    yt, t = t.execute_block(torch.from_numpy(x))
    yj, j = j.execute_block(jnp.asarray(x))
    _close(yt.numpy(), yj)  # locked: the output is x·g, unscaled
    assert torch.equal(t.g, torch.ones(2))
    t, j = t.unlock().init(torch.from_numpy(x)), j.unlock().init(jnp.asarray(x))
    _close(t.get_rssi().numpy(), j.get_rssi())
    _close(t.get_signal_level().numpy(), j.get_signal_level())
    yt, t = t.set_gain(2.0).execute_block(torch.from_numpy(x))
    yj, j = j.set_gain(2.0).execute_block(jnp.asarray(x))
    _close(yt.numpy(), yj)
    assert float(t.get_scale()[0]) == 4.0 and float(t.get_bandwidth()[1]) == pytest.approx(0.1)
    t = t.squelch_enable().reset()
    assert torch.equal(t.g, torch.ones(2)) and not t.locked.any()
    assert (t.squelch_get_status() == AgcSquelchMode.ENABLED).all()
    assert (t.squelch_disable().reset().squelch_mode == AgcSquelchMode.DISABLED).all()


def test_state_round_trip_from_yagi_tpu():
    x = _noise(4, (5, 50), 3.0)
    _, j = JAgc.create(bandwidth=0.03, batch_shape=(5,)).execute_block(jnp.asarray(x))
    t = load_state(Agc, j, device=DEV)
    assert t.locked.dtype == torch.bool and t.squelch_mode.dtype == torch.int32
    x2 = _noise(5, (5, 80), 3.0)
    yt, t = t.execute_block(torch.from_numpy(x2))
    yj, j = j.execute_block(jnp.asarray(x2))
    _close(yt.numpy(), yj)
    _same_state(t, j)


@pytest.mark.parametrize("make", [
    lambda: Agc.create(bandwidth=1.5, device=DEV), lambda: Agc.create(bandwidth=-0.1, device=DEV),
    lambda: Agc.create(device=DEV).set_bandwidth(2.0),
    lambda: Agc.create(device=DEV).set_signal_level(0.0),
    lambda: Agc.create(device=DEV).set_gain(-1.0), lambda: Agc.create(device=DEV).set_scale(0.0),
    lambda: Agc.create(device=DEV).squelch_set_timeout(0),
    lambda: Agc.create(device=DEV).init(torch.zeros(0, dtype=torch.complex64)),
    lambda: Agc.create(device=DEV).execute_block(torch.zeros(10, dtype=torch.complex64),
                                                 samples_per_step=3),
])
def test_rejects_bad_config(make):
    with pytest.raises(ConfigError):
        make()


@pytest.mark.parametrize("bad", ["rank", "dtype", "g_shape", "locked", "mode"])
def test_apply_rejects_bad_input(bad):
    t = Agc.create(batch_shape=(2,), device=DEV)
    kw = dict(x=torch.zeros(2, 8, dtype=torch.complex64), g=t.g, y2_prime=t.y2_prime,
              alpha=t.alpha, scale=t.scale, squelch_threshold=t.squelch_threshold,
              locked=t.locked, squelch_mode=t.squelch_mode, squelch_timer=t.squelch_timer)
    if bad == "rank":
        kw["x"] = kw["x"][0]
    elif bad == "dtype":
        kw["x"] = kw["x"].to(torch.complex128)
    elif bad == "g_shape":
        kw["g"] = torch.ones(3)
    elif bad == "locked":
        kw["locked"] = kw["locked"].int()
    else:
        kw["squelch_mode"] = kw["squelch_mode"].long()
    with pytest.raises((ValueError, TypeError)):
        agc_scan_apply(**kw, timeout=100)


@pytest.mark.parametrize("n", [1, 127, 129])
def test_execute_block_at_tile_edges_matches_yagi_tpu(n):
    """Block lengths around the kernel's 128-sample slab, three blocks each,
    13 channels (not a multiple of its channel group)."""
    x = _noise(20 + n, (13, 3 * n)) * np.geomspace(0.01, 20.0, 13, dtype=np.float32)[:, None]
    j = JAgc.create(bandwidth=0.05, batch_shape=(13,))
    t = Agc.create(bandwidth=0.05, batch_shape=(13,), device=DEV)
    for blk in np.split(x, 3, axis=-1):
        yj, j = j.execute_block(jnp.asarray(blk))
        yt, t = t.execute_block(torch.from_numpy(blk))
        assert yt.shape == (13, n)
        _close(yt.numpy(), yj)
        _same_state(t, j)
