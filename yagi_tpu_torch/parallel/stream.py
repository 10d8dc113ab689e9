"""Multi-rank streaming: time-block sharding with an overlap-save halo exchange.

Port of :mod:`yagi_tpu.parallel.stream` onto ``torch.distributed`` (no
reference equivalent: the reference is single-threaded). A continuous sample
stream is laid out as [channels, time], channels sharded over the mesh
dimension ``"ch"`` and time blocks over ``"time"``. A causal filter needs the
last L−1 samples of the previous time block, the halo, which each rank
receives from its left neighbour on ``"time"`` by one
``batch_isend_irecv`` before its local convolution. The output is
bit-identical to the same per-block computation run in one process, because
each rank convolves exactly the ``concat(history, block)`` that process
would.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._src.device import resolve_device
from ..errors import ConfigError
from ..filter._conv import causal_conv_valid, np_taps

__all__ = [
    "halo_exchange_left",
    "time_sharded_fir",
    "make_stream_mesh",
]


def make_stream_mesh(n_devices: int | None = None, ch: int = 1, device_type=None) -> DeviceMesh:
    """Mesh with ("ch", "time") dimensions over every rank of the world.

    Shape (ch, n // ch) if ``ch`` > 1 divides the world size n, else (1, n).
    ``device_type`` is the card's unless the caller passes ``"cpu"``;
    ``n_devices``, where given, must be the world size: a rank cannot leave
    the mesh.
    """
    device_type = resolve_device(device_type).type
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ConfigError(
            f"n_devices={n_devices}: the mesh spans all {n} ranks of the world "
            f"(one card a rank), so n_devices must be None or {n}")
    shape = (ch, n // ch) if ch > 1 and n % ch == 0 else (1, n)
    return init_device_mesh(device_type, shape, mesh_dim_names=("ch", "time"))


def time_ring(mesh: DeviceMesh) -> tuple[dist.ProcessGroup, int, int]:
    """The ``"time"`` group of ``mesh``, its size, and this rank's index in it."""
    group = mesh.get_group("time")
    return group, dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())


def wire(t: torch.Tensor) -> torch.Tensor:
    """What goes over the wire: complex tensors as their float view, which
    every backend takes."""
    return torch.view_as_real(t) if t.is_complex() else t


def exchange(group: dist.ProcessGroup, send: torch.Tensor | None, dst: int,
             recv: torch.Tensor | None, src: int) -> None:
    """Send ``send`` to group rank ``dst`` and receive ``recv`` (in place)
    from group rank ``src`` in one ``batch_isend_irecv``, and wait for both;
    ``None`` leaves that half out. Both tensors must be contiguous."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, wire(send), dist.get_global_rank(group, dst), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, wire(recv), dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def tail(block: torch.Tensor, halo: int) -> torch.Tensor:
    """The last ``halo`` samples of ``block``, contiguous."""
    if halo > block.shape[-1]:
        raise ConfigError(
            f"a local block of {block.shape[-1]} samples cannot supply a halo of {halo}")
    return block[..., block.shape[-1] - halo :].contiguous()


def halo_exchange_left(block: torch.Tensor, halo: int, mesh: DeviceMesh) -> torch.Tensor:
    """The last ``halo`` samples of the LEFT neighbour's block on ``"time"``.

    Time rank 0 receives zeros (the stream's start). Each rank sends its
    own tail to its right neighbour: one ``batch_isend_irecv``.
    """
    group, n, r = time_ring(mesh)
    send = tail(block, halo)
    recv = torch.zeros_like(send)
    if halo:
        exchange(group, send if r + 1 < n else None, r + 1, recv if r > 0 else None, r - 1)
    return recv


def time_sharded_fir(h, x_local: torch.Tensor, mesh: DeviceMesh, history=None) -> torch.Tensor:
    """FIR-filter this rank's block of a [ch, time] stream sharded over a
    ("ch", "time") mesh.

    The stream's output equals ``FirFilter.create(h, ...).execute_block``
    over the same blocks in one process: each rank takes its left halo and
    runs the banded-matmul convolution over ``[halo | block]``. ``history``
    ([ch_loc, L−1]) seeds the stream start and is used on time rank 0 only.
    """
    h = torch.from_numpy(np_taps(h.cpu().numpy() if isinstance(h, torch.Tensor) else h))
    h = h.to(x_local.device)
    L = h.shape[0]
    halo = halo_exchange_left(x_local, L - 1, mesh)
    if history is not None and time_ring(mesh)[2] == 0:
        halo = torch.as_tensor(history, device=x_local.device)
    xa = torch.cat([halo.to(x_local.dtype), x_local], dim=-1)
    return causal_conv_valid(xa, h)
