"""Distributed streaming over ``torch.distributed`` (no reference equivalent).

Port of :mod:`yagi_tpu.parallel`. yagi_tpu drives every device from one
process through ``shard_map`` over a ``jax.sharding.Mesh``; here each card
has a process of its own (SPMD over ``torch.distributed``: one rank a card,
started by ``torchrun`` or :func:`initialize_multihost`), and a
:class:`torch.distributed.device_mesh.DeviceMesh` with the dimensions
``("ch", "time")`` takes the place of the JAX mesh. So every function below
takes the calling **rank's local shard** and returns the rank's local output:
the arrays a ``shard_map`` body sees in yagi_tpu. Every other argument and
every name is yagi_tpu's.

The shards follow the mesh: time rank r of ``mesh.get_group("time")`` holds
the r-th contiguous time block of the stream, channel rank c the c-th group
of channels. A channel-sharded output (``*_to_channels``) is the reverse:
time rank r holds channels [r·M/n, (r+1)·M/n) over the whole stream.

Collectives run on the mesh's groups: NCCL between cards, gloo between CPU
processes (only when the caller asks for the CPU). A failed collective
raises; nothing falls back to a single process.
"""

from .stream import (  # noqa: F401
    halo_exchange_left,
    make_stream_mesh,
    time_sharded_fir,
)
from .channelizer import (  # noqa: F401
    sharded_channelize,
    sharded_channelize_fm,
    sharded_channelize_to_channels,
    sharded_channelize_fm_to_channels,
    sharded_channelize_stream_to_channels,
    sharded_channelize_stream_fm_to_channels,
)
