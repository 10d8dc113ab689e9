"""Multi-host streaming: one process a card, over every host.

Port of :mod:`yagi_tpu.parallel.multihost` onto ``torch.distributed``. Each
process feeds its local time block of the sample stream, a mesh spans every
process's card, and the sharded streaming functions (halo exchange,
``all_to_all`` channel redistribution) run unchanged: NCCL carries the
shard-boundary collectives over NVLink within a host and the network across
hosts.

Wiring on every process (``yagi_tpu_torch/tools/multihost_worker.py`` is the
runnable pattern, checked on the CPU with four gloo processes):

    initialize_multihost(coordinator, num_processes, process_id)
    mesh  = global_time_mesh()
    x     = distribute_time_stream(x_local, mesh)   # this rank's block
    y     = time_sharded_fir(h, x, mesh)            # or any sharded function
    y_all = gather_to_hosts(y)                      # the whole result, numpy

Under ``torchrun --nproc-per-node=<cards>`` ``initialize_multihost()`` takes
no arguments.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._src.device import resolve_device
from ..errors import ConfigError
from .stream import make_stream_mesh, wire

__all__ = [
    "initialize_multihost",
    "global_time_mesh",
    "distribute_time_stream",
    "gather_to_hosts",
]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the ``torch.distributed`` world (a second call does nothing).

    ``backend`` is ``"nccl"`` (the default: one card a process, which it
    selects by ``LOCAL_RANK``, or by rank modulo the cards of the host) or
    ``"gloo"``, which runs on the CPU and only when asked for. With no
    ``coordinator_address`` the rendezvous is torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); otherwise
    ``host:port`` or an init-method URL (``tcp://…``, ``file://…``) with
    ``num_processes`` and ``process_id``.
    """
    if dist.is_initialized():
        return
    backend = "nccl" if backend is None else backend
    if backend not in ("nccl", "gloo"):
        raise ConfigError(f"backend {backend!r}: the port runs on 'nccl' (the card) or 'gloo' (CPU)")
    if backend == "nccl":
        resolve_device(None)  # DeviceError where there is no card
        rank = process_id if process_id is not None else int(os.environ["RANK"])
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    given = {k: v for k, v in (("world_size", num_processes), ("rank", process_id)) if v is not None}
    dist.init_process_group(backend, init_method=url, **given)


def global_time_mesh(ch: int = 1, device_type=None) -> DeviceMesh:
    """("ch", "time") mesh over every rank of every process.

    Ranks follow the world's order, so consecutive time shards land on one
    host first: halo exchanges cross hosts once per host boundary.
    ``device_type`` is the card's unless the caller passes ``"cpu"``.
    """
    return make_stream_mesh(None, ch, device_type)


def distribute_time_stream(x_local, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous time block, on its device (the card of its
    process, or the CPU of a ``"cpu"`` mesh), with no copy between ranks:
    the stream, sharded on ``"time"``, is the blocks of all ranks in order."""
    if mesh.device_type == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device(mesh.device_type, torch.cuda.current_device())
    return torch.as_tensor(x_local, device=device)


def gather_to_hosts(y_local: torch.Tensor, dim: int = -1, group=None) -> np.ndarray:
    """Every rank's block of a sharded result, joined along ``dim`` in rank
    order (over the whole world, or ``group``), as numpy on every rank: one
    ``all_gather_into_tensor``."""
    n = dist.get_world_size(group)
    part = y_local.movedim(dim, 0).contiguous()
    out = torch.empty((n * part.shape[0],) + part.shape[1:], dtype=part.dtype, device=part.device)
    dist.all_gather_into_tensor(wire(out), wire(part), group=group)
    return out.movedim(0, dim).cpu().numpy()
