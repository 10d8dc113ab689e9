"""yagi_tpu_torch.parallel on torch.distributed: four gloo ranks on the CPU.

* Sharded against one process, bit for bit: four ranks of
  ``yagi_tpu_torch/tools/multihost_worker.py`` (gloo, a FileStore under
  tmp_path, one thread a rank) run every sharded function once and write the
  gathered outputs to an .npz; each test below holds one output against the
  port's one-process sequential computation (the cases of
  tests/test_parallel.py, tests/test_channelizer.py's sharded channelizer
  and tests/test_multihost.py): ``time_sharded_fir`` on a (2, 2) mesh with
  and without history, the six channelizer functions at M = 64 on a time
  mesh of the four ranks, ``halo_exchange_left``'s zeros on time rank 0, the
  mesh shapes. The channel outputs equal the one-process analyzer past its
  zero-state transient, as in yagi_tpu. The FM outputs do too, on rows of
  whole multiples of 32 samples: ATen's vectorized atan2 and its scalar
  remainder loop differ by an ulp on the CPU (the worker's shapes keep every
  row whole).
* Port against yagi_tpu: the same inputs through yagi_tpu's sharded
  functions on a 4-device mesh of conftest's 8 virtual CPU devices, within
  the Firpfbch tolerance (atol 1e-5; FM by wrapped phase where both
  discriminator inputs are at least 5% of the rms).
* World size 1 in this process (gloo): the paths a single card runs, where
  the stream's cyclic halo is a send to itself taken locally.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from yagi_tpu import parallel as jpar
from yagi_tpu.multichannel import Firpfbch as JFirpfbch
from yagi_tpu_torch.filter import FirFilter
from yagi_tpu_torch.modem import Freqdem
from yagi_tpu_torch.multichannel import Firpfbch
from yagi_tpu_torch.parallel import (
    halo_exchange_left,
    make_stream_mesh,
    sharded_channelize,
    sharded_channelize_fm,
    sharded_channelize_fm_to_channels,
    sharded_channelize_stream_fm_to_channels,
    sharded_channelize_stream_to_channels,
    sharded_channelize_to_channels,
    time_sharded_fir,
)
from yagi_tpu_torch.parallel.multihost import distribute_time_stream, gather_to_hosts
from yagi_tpu_torch.tools import multihost_worker as W

torch.set_num_threads(1)

DEV = "cpu"  # the objects of these tests are built on the CPU
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
LAUNCH_TIMEOUT = 120  # seconds for all four ranks: a hang fails, it does not stall


def launch_ranks(tmp, n: int, ch: int) -> tuple[dict, str]:
    """Start ``n`` gloo ranks of the worker, wait for all (at most
    LAUNCH_TIMEOUT s), and return rank 0's gathered outputs and its log."""
    out = os.path.join(tmp, "out.npz")
    env = {**os.environ, "MULTIHOST_COORD": "file://" + os.path.join(tmp, "rendezvous"),
           "MULTIHOST_N": str(n), "MULTIHOST_DEVICE": "cpu", "MULTIHOST_CH": str(ch),
           "MULTIHOST_OUT": out, "OMP_NUM_THREADS": "1"}
    worker = os.path.join(_ROOT, "yagi_tpu_torch", "tools", "multihost_worker.py")
    procs = [subprocess.Popen([sys.executable, worker], env={**env, "MULTIHOST_ID": str(i)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=_ROOT) for i in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {i} failed:\n{log}"
    with np.load(out) as f:
        return dict(f), logs[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch_ranks(str(tmp_path_factory.mktemp("ranks")), N_RANKS, ch=2)[0]


@pytest.fixture(scope="module")
def single(ranks):
    """The port's one-process results on the ranks' inputs."""
    p = Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV).p

    def analyze(x):
        return Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV).analyzer_execute(
            torch.from_numpy(x))[0]

    y = analyze(ranks["chz_x"])
    T = y.shape[-1]
    chz, dem, fm = Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV), Freqdem.create(
        W.KF, (W.M,), device=DEV), []
    for b in range(N_RANKS):  # Firpfbch → Freqdem block by block, a rank's block each
        yb, chz = chz.analyzer_execute(torch.from_numpy(ranks["chz_x"][b * W.STEPS * W.M:
                                                                       (b + 1) * W.STEPS * W.M]))
        m, dem = dem.demodulate(yb)
        fm.append(m)
    ys = analyze(ranks["chz_blocks"].reshape(-1))
    ys_fm, _ = Freqdem.create(W.KF, (W.M,), device=DEV).demodulate(ys)
    return {
        "p": p,
        "y": y.numpy(),
        "fm_blocks": torch.cat(fm, dim=-1).numpy(),
        "fm_whole": _disc(y).numpy(),
        "stream": ys.reshape(W.M, W.B, T).permute(1, 0, 2).numpy(),
        "stream_fm": ys_fm.reshape(W.M, W.B, T).permute(1, 0, 2).numpy(),
        "stream_y": ys.numpy(),
    }


def _disc(y: torch.Tensor) -> torch.Tensor:
    """The discriminator's ops over a whole stream, pairs (g, g + 1): the
    channel-sharded paths' formula (Freqdem's), so the rows split as theirs
    do between ATen's vector loop and its remainder."""
    return torch.angle(y[..., :-1].conj() * y[..., 1:]) * float(np.float32(1 / (2 * np.pi * W.KF)))


def fir_blockwise(x, h, hist, n_time: int) -> np.ndarray:
    f = FirFilter.create(h, batch_shape=(x.shape[0],), dtype=torch.complex64, device=DEV)
    if hist is not None:
        f = f.write(torch.from_numpy(hist))
    step = x.shape[1] // n_time
    parts = []
    for b in range(n_time):
        y, f = f.execute_block(torch.from_numpy(x[:, b * step:(b + 1) * step]))
        parts.append(y.numpy())
    return np.concatenate(parts, axis=-1)


# -------------------------------------------- sharded against one process
@pytest.mark.parametrize("key, with_history", [("fir", False), ("fir_history", True)])
def test_time_sharded_fir_matches_blockwise(ranks, key, with_history):
    """(2, 2) mesh: 2 channel groups × 2 time blocks == the same blocks run
    in sequence by one FirFilter (tests/test_parallel.py::TestTimeShardedFir)."""
    assert tuple(ranks["mesh_shape_ch2"]) == (2, 2)
    want = fir_blockwise(ranks["fir_x"], ranks["fir_h"],
                         ranks["fir_hist"] if with_history else None, 2)
    np.testing.assert_array_equal(ranks[key], want)


@pytest.mark.parametrize("ch, shape", [(1, (1, 4)), (2, (2, 2)), (3, (1, 4))])
def test_mesh_shapes(ranks, ch, shape):
    assert tuple(ranks[f"mesh_shape_ch{ch}"]) == shape


def test_n_devices_other_than_the_world_raises_config_error(ranks):
    assert bool(ranks["bad_n_devices_raised"])


def test_halo_exchange_left_zeros_on_rank_0(ranks):
    """Each rank filled its [2, 8] block with rank + 1: time rank r gets
    the left neighbour's last 3 samples (r), time rank 0 zeros."""
    halo = ranks["halo"].reshape(N_RANKS, 2, 3)
    for r in range(N_RANKS):
        np.testing.assert_array_equal(halo[r], np.full((2, 3), r, np.complex64))


@pytest.mark.parametrize("key", ["channelize", "to_channels"])
def test_channelize_matches_one_process(ranks, single, key):
    """Time-sharded in (time- or channel-sharded out, the all_to_all) == the
    one-process analyzer from step p."""
    p = single["p"]
    assert ranks[key].shape == single["y"].shape
    np.testing.assert_array_equal(ranks[key][:, p:], single["y"][:, p:])


def test_channelize_fm_matches_one_process(ranks, single):
    """(p+1)·M halo: == Firpfbch → Freqdem block by block, past rank 0's
    transient (tests/test_channelizer.py::test_fm_workload)."""
    p = single["p"]
    np.testing.assert_array_equal(ranks["channelize_fm"][:, p + 2:],
                                  single["fm_blocks"][:, p + 2:])


def test_fm_to_channels_has_no_seams(ranks, single):
    """Channel-sharded FM demod == the discriminator over the whole stream."""
    p = single["p"]
    T = single["y"].shape[-1]
    assert ranks["fm_to_channels"].shape == (W.M, T - 1)
    np.testing.assert_array_equal(ranks["fm_to_channels"][:, p:], single["fm_whole"][:, p:])


@pytest.mark.parametrize("key, skip", [("stream", 0), ("stream_fm", 1)])
def test_stream_matches_one_process(ranks, single, key, skip):
    """Pipelined B-block stream == the one-process analyzer (→ Freqdem) over
    the concatenated stream: block 0 past the transient, later blocks whole
    (the carried halo crosses from rank n−1 to rank 0)."""
    p = single["p"] + skip
    got, want = ranks[key], single[key]
    assert got.shape == want.shape == (W.B, W.M, N_RANKS * W.STEPS)
    np.testing.assert_array_equal(got[0][:, p:], want[0][:, p:])
    np.testing.assert_array_equal(got[1:], want[1:])


# ------------------------------------------------------ port against yagi_tpu
def _time_mesh():
    return Mesh(np.asarray(jax.devices()[:N_RANKS]), ("time",))


def _jit(fn, *args):
    """yagi_tpu's sharded function on a 4-device time mesh, jitted as its own
    tests run it; the last argument is the stream."""
    mesh = _time_mesh()
    return np.asarray(jax.jit(lambda v: fn(*args[:-1], v, mesh))(jnp.asarray(args[-1])))


def _phase_err(m_a, m_b, y, y_prev_last) -> float:
    """Largest wrapped phase difference (radians) over the samples whose two
    discriminator inputs are both at least 5% of the rms (arg() is
    ill-conditioned near 0)."""
    mag = np.abs(y)
    mag_prev = np.concatenate([np.abs(y_prev_last)[:, None], mag[:, :-1]], axis=1)
    rms = np.sqrt(np.mean(mag ** 2))
    keep = (mag >= 0.05 * rms) & (mag_prev >= 0.05 * rms)
    d = np.angle(np.exp(1j * (m_a - m_b).astype(np.float64) * 2 * np.pi * W.KF))
    assert keep.mean() > 0.9  # the check is not vacuous
    return float(np.abs(d[keep]).max())


@pytest.mark.parametrize("key, with_history", [("fir", False), ("fir_history", True)])
def test_time_sharded_fir_matches_yagi_tpu(ranks, key, with_history):
    if len(jax.devices()) < N_RANKS:
        pytest.skip("needs 4 virtual devices")
    mesh = jpar.make_stream_mesh(N_RANKS, ch=2)
    hist = jnp.asarray(ranks["fir_hist"]) if with_history else None
    want = np.asarray(jax.jit(lambda v: jpar.time_sharded_fir(ranks["fir_h"], v, mesh,
                                                              history=hist))(ranks["fir_x"]))
    np.testing.assert_allclose(ranks[key], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("key, fn", [("channelize", jpar.sharded_channelize),
                                     ("to_channels", jpar.sharded_channelize_to_channels)])
def test_channelize_matches_yagi_tpu(ranks, single, key, fn):
    p = single["p"]
    want = _jit(fn, JFirpfbch.create_kaiser(W.M, 4, 60.0), ranks["chz_x"])
    assert want.shape == ranks[key].shape
    np.testing.assert_allclose(ranks[key][:, p:], want[:, p:], rtol=0, atol=1e-5)


def test_stream_matches_yagi_tpu(ranks, single):
    p = single["p"]
    want = _jit(jpar.sharded_channelize_stream_to_channels, JFirpfbch.create_kaiser(W.M, 4, 60.0),
                ranks["chz_blocks"])
    assert want.shape == ranks["stream"].shape
    np.testing.assert_allclose(ranks["stream"][0][:, p:], want[0][:, p:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ranks["stream"][1:], want[1:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", ["channelize_fm", "fm_to_channels", "stream_fm"])
def test_fm_matches_yagi_tpu(ranks, single, key):
    p = single["p"]
    chz, x = JFirpfbch.create_kaiser(W.M, 4, 60.0), ranks["chz_x"]
    y = single["y"]
    if key == "channelize_fm":  # [:, g] is the pair (g − 1, g)
        want = _jit(jpar.sharded_channelize_fm, chz, W.KF, x)
        got, y_in, prev = ranks[key][:, p + 2:], y[:, p + 2:], y[:, p + 1]
        want = want[:, p + 2:]
    elif key == "fm_to_channels":  # [:, g] is the pair (g, g + 1)
        want = _jit(jpar.sharded_channelize_fm_to_channels, chz, W.KF, x)
        got, y_in, prev, want = ranks[key][:, p:], y[:, p + 1:], y[:, p], want[:, p:]
    else:  # the whole stream, its blocks side by side
        want = _jit(jpar.sharded_channelize_stream_fm_to_channels, chz, W.KF, ranks["chz_blocks"])
        T = want.shape[-1]
        got = np.concatenate(list(ranks[key]), axis=-1)[:, p + 1:]
        want = np.concatenate(list(want), axis=-1)[:, p + 1:]
        y_in, prev = single["stream_y"][:, p + 1:], single["stream_y"][:, p]
        assert got.shape == (W.M, W.B * T - p - 1)
    assert got.shape == want.shape
    assert _phase_err(got, want, y_in, prev) <= 1e-4


# ------------------------------------------------- world size 1, in process
@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of this one process: a card's run at world size 1."""
    assert not dist.is_initialized()
    store = dist.FileStore(str(tmp_path_factory.mktemp("world1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_stream_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _blocks(rng, b: int, steps: int) -> torch.Tensor:
    x = rng.standard_normal((b, steps * W.M)) + 1j * rng.standard_normal((b, steps * W.M))
    return torch.from_numpy(x.astype(np.complex64))


def test_world1_stream_fm_matches_blockwise(world1):
    """The self-halo: every block's lead is the rank's own carried tail; ==
    Firpfbch → Freqdem with carried state, bit for bit, all blocks whole."""
    rng = np.random.default_rng(60)
    xb = _blocks(rng, 4, 64)
    got = sharded_channelize_stream_fm_to_channels(
        Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV), W.KF, xb, world1)
    ref, dem, want = (Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV),
                      Freqdem.create(W.KF, (W.M,), device=DEV), [])
    for x in xb:
        y, ref = ref.analyzer_execute(x)
        m, dem = dem.demodulate(y)
        want.append(m)
    assert got.shape == (4, W.M, 64)
    torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=0)


def test_world1_stream_and_functions_match_one_process(world1):
    rng = np.random.default_rng(61)
    xb = _blocks(rng, 3, 64)
    chz = Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV)
    p = chz.p
    y_all, _ = Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV).analyzer_execute(xb.reshape(-1))
    got = sharded_channelize_stream_to_channels(chz, xb, world1)
    torch.testing.assert_close(got, y_all.reshape(W.M, 3, 64).permute(1, 0, 2), rtol=0, atol=0)
    y0, _ = Firpfbch.create_kaiser(W.M, 4, 60.0, device=DEV).analyzer_execute(xb[0])
    for fn in (sharded_channelize, sharded_channelize_to_channels):
        torch.testing.assert_close(fn(chz, xb[0], world1)[:, p:], y0[:, p:], rtol=0, atol=0)
    fm0, _ = Freqdem.create(W.KF, (W.M,), device=DEV).demodulate(y0)
    torch.testing.assert_close(sharded_channelize_fm(chz, W.KF, xb[0], world1), fm0,
                               rtol=0, atol=0)
    torch.testing.assert_close(sharded_channelize_fm_to_channels(chz, W.KF, xb[0], world1),
                               _disc(y0), rtol=0, atol=0)


@pytest.mark.parametrize("with_history", [False, True])
def test_world1_fir_matches_filter(world1, with_history):
    rng = np.random.default_rng(62)
    h = rng.standard_normal(16).astype(np.float32)
    x = (rng.standard_normal((3, 256)) + 1j * rng.standard_normal((3, 256))).astype(np.complex64)
    hist = ((rng.standard_normal((3, 15)) + 1j * rng.standard_normal((3, 15))).astype(np.complex64)
            if with_history else None)
    got = time_sharded_fir(h, torch.from_numpy(x), world1,
                           history=None if hist is None else torch.from_numpy(hist))
    np.testing.assert_array_equal(got.numpy(), fir_blockwise(x, h, hist, 1))


def test_world1_halo_is_zeros(world1):
    blk = torch.ones(2, 8, dtype=torch.complex64)
    torch.testing.assert_close(halo_exchange_left(blk, 3, world1), torch.zeros(2, 3, dtype=torch.complex64))


def test_world1_gather_and_distribute(world1):
    x = np.arange(12, dtype=np.complex64).reshape(3, 4)
    t = distribute_time_stream(x, world1)
    assert t.device.type == "cpu" and np.shares_memory(t.numpy(), x)  # no copy
    for dim in (0, -1):
        np.testing.assert_array_equal(gather_to_hosts(t, dim), x)


def test_world1_block_shorter_than_its_halo_raises(world1):
    from yagi_tpu_torch.errors import ConfigError

    with pytest.raises(ConfigError):
        halo_exchange_left(torch.zeros(2, 4, dtype=torch.complex64), 5, world1)
