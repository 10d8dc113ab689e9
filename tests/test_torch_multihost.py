"""yagi_tpu_torch.parallel.multihost: a four-process run on the CPU.

tests/test_multihost.py runs yagi_tpu's worker as 2 processes × 2 virtual
devices; torch has one rank a device, so the port's worker
(``yagi_tpu_torch/tools/multihost_worker.py``) runs as 4 gloo processes,
one thread each, meeting through a FileStore under tmp_path. Each joins with
``initialize_multihost``, builds ``global_time_mesh()``, feeds its own block
through ``distribute_time_stream``, runs the sharded FIR, the 64-channel
``all_to_all`` channelizer and the double-buffered FM stream, and gathers
with ``gather_to_hosts``; rank 0 checks every result bit for bit against the
one-process sequential computation and prints the OK lines. Then: the
gathered FIR against the port's FirFilter here, the entry points' device
rule (the card unless the caller asks for the CPU), and the rendezvous
being idempotent.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from yagi_tpu_torch.errors import ConfigError, DeviceError
from yagi_tpu_torch.multichannel import Firpfbch
from yagi_tpu_torch.parallel import make_stream_mesh
from yagi_tpu_torch.parallel.multihost import (
    distribute_time_stream,
    gather_to_hosts,
    global_time_mesh,
    initialize_multihost,
)
from yagi_tpu_torch.tools import multihost_worker as W

from test_torch_parallel import fir_blockwise, launch_ranks

torch.set_num_threads(1)

N_RANKS = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Four ranks on a (1, 4) time mesh: (rank 0's gathered outputs, its log)."""
    return launch_ranks(str(tmp_path_factory.mktemp("multihost")), N_RANKS, ch=1)


@pytest.mark.parametrize("line", [
    f"MULTIHOST_OK procs={N_RANKS} mesh=(1, {N_RANKS})",
    f"MULTIHOST_CHANNELIZER_OK M={W.M} T={N_RANKS * W.STEPS} procs={N_RANKS}",
    f"MULTIHOST_PIPELINED_STREAM_OK B={W.B} M={W.M} T={N_RANKS * W.STEPS} procs={N_RANKS}",
])
def test_four_process_stream(run, line):
    """Rank 0's bit-for-bit checks passed (tests/test_multihost.py's lines)."""
    assert line in run[1], run[1]


@pytest.mark.parametrize("key, with_history", [("fir", False), ("fir_history", True)])
def test_gathered_fir_matches_blockwise(run, key, with_history):
    out = run[0]
    assert tuple(out["mesh_shape_ch1"]) == (1, N_RANKS)
    want = fir_blockwise(out["fir_x"], out["fir_h"], out["fir_hist"] if with_history else None,
                         N_RANKS)
    np.testing.assert_array_equal(out[key], want)


def test_stream_gathered_in_rank_order(run):
    """gather_to_hosts joined the four channel groups in rank order: the
    stream's outputs have all M channels, each group where it belongs."""
    out, p = run[0], Firpfbch.create_kaiser(W.M, 4, 60.0, device="cpu").p
    assert out["stream"].shape == (W.B, W.M, N_RANKS * W.STEPS)
    assert out["to_channels"].shape == (W.M, N_RANKS * W.STEPS)
    np.testing.assert_array_equal(out["to_channels"][:, p:], out["channelize"][:, p:])


# ----------------------------------------------------------- the device rule
@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: make_stream_mesh(),
    lambda: global_time_mesh(),
    lambda: initialize_multihost("file:///nonexistent/rendezvous", 1, 0),
])
def test_entry_points_default_to_the_card(no_card, entry):
    """With no card and no explicit "cpu" they raise DeviceError, never fall
    back to the CPU (and never reach a rendezvous)."""
    assert not dist.is_initialized()
    with pytest.raises(DeviceError):
        entry()


def test_unknown_backend_raises_config_error():
    with pytest.raises(ConfigError, match="mpi"):
        initialize_multihost("file:///nonexistent/rendezvous", 1, 0, backend="mpi")


def test_initialize_is_idempotent_and_meshes_on_cpu(tmp_path):
    url = "file://" + str(tmp_path / "rendezvous")
    initialize_multihost(url, 1, 0, backend="gloo")
    try:
        initialize_multihost(url, 1, 0, backend="gloo")  # a second call does nothing
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = global_time_mesh(device_type="cpu")
        assert mesh.device_type == "cpu" and tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("ch", "time")
        with pytest.raises(ConfigError, match="n_devices=2"):
            make_stream_mesh(2, device_type="cpu")
        x = np.arange(6, dtype=np.complex64).reshape(2, 3)
        t = distribute_time_stream(x, mesh)
        np.testing.assert_array_equal(gather_to_hosts(t), x)
    finally:
        dist.destroy_process_group()
