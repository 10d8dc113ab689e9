"""Distributed channelizer: time-sharded polyphase analysis + per-channel demod.

Port of :mod:`yagi_tpu.parallel.channelizer` onto ``torch.distributed``
(BASELINE config[4]: the M-channel firpfbch channelizer with time blocks
sharded over ranks). Each rank receives its contiguous time block plus a
p·M-sample halo from its left neighbour on ``"time"`` (one
``batch_isend_irecv``), runs the analyzer on ``[halo | block]`` from the
state it is given (a fresh bank: zero state), and drops the first p output
steps, which depended only on the halo: overlap-save. The retained outputs
equal a one-process run because the analyzer state is a function of the
last (p−1)·M + M−1 raw samples, which the halo covers.

The analyzer is the plain :class:`~yagi_tpu_torch.multichannel.Firpfbch`, as
in yagi_tpu: the fused K2 bank (``FusedChannelizer``) reads whole tiles of
its block, which a p·M halo breaks.

Per-channel demodulation is local to a rank. The ``*_to_channels`` forms
first redistribute with one ``all_to_all``: rank r then holds channels
[r·M/n, (r+1)·M/n) over the whole stream, so feedback loops that run along
time (symsync, PLL, AGC) see no block seams.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..errors import ConfigError
from ..multichannel import Firpfbch
from .stream import exchange, halo_exchange_left, tail, time_ring, wire

__all__ = [
    "sharded_channelize",
    "sharded_channelize_fm",
    "sharded_channelize_to_channels",
    "sharded_channelize_fm_to_channels",
    "sharded_channelize_stream_to_channels",
    "sharded_channelize_stream_fm_to_channels",
]


def _local_analyze(ch: Firpfbch, halo_and_block: torch.Tensor) -> torch.Tensor:
    """Analyzer over [halo | block], dropping the halo-only output steps."""
    y, _ = ch.analyzer_execute(halo_and_block)
    return y[..., ch.p :]


def _fm_ref(kf: float) -> float:
    """1/(2π·kf) rounded to float32, as :class:`~yagi_tpu_torch.modem.Freqdem` takes it."""
    return float(np.float32(1.0 / (2.0 * np.pi * kf)))


def _discriminate(y: torch.Tensor, ref: float) -> torch.Tensor:
    """m[n] = arg(conj(y[n−1])·y[n])·ref along the last axis: Freqdem's ops."""
    return torch.angle(y[..., :-1].conj() * y[..., 1:]) * ref


def _start_to_channels(y: torch.Tensor, group, n: int, async_op: bool = False):
    """Issue the ``all_to_all`` of y [M, t] on ``group``: returns (work,
    received [n, M/n, t], the send buffer, kept alive until the work ends).
    The counterpart of JAX's ``all_to_all(y, split_axis=0, concat_axis=1,
    tiled=True)``."""
    M, t = y.shape[-2:]
    if M % n:
        raise ConfigError(f"{M} channels do not split over {n} time ranks")
    send = y.reshape(n, M // n, t).contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(wire(recv), wire(send), group=group, async_op=async_op)
    return work, recv, send


def _join(recv: torch.Tensor) -> torch.Tensor:
    """[n, M/n, t] from the n time ranks → [M/n, n·t] in stream order."""
    n, m, t = recv.shape
    return recv.permute(1, 0, 2).reshape(m, n * t)


def sharded_channelize(ch: Firpfbch, x_local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Channelize this rank's block [t_loc·M] of a time-sharded stream.

    Returns this rank's channels [M, t_loc]: the values a one-process
    ``ch.analyzer_execute`` (zero initial state) gives over the whole
    stream, except the stream's first p output steps, zero-state transients
    on both paths.
    """
    lead = halo_exchange_left(x_local, ch.p * ch.num_channels, mesh)
    return _local_analyze(ch, torch.cat([lead, x_local], dim=-1))


def sharded_channelize_to_channels(ch: Firpfbch, x_local: torch.Tensor,
                                   mesh: DeviceMesh) -> torch.Tensor:
    """Time-sharded input → CHANNEL-sharded output via one ``all_to_all``.

    Each rank channelizes its time block (halo, overlap-save), then the
    ``all_to_all`` splits the M channels into n groups and joins the time
    blocks: rank r returns channels [r·M/n, (r+1)·M/n) over the whole
    stream, [M/n, n·t_loc]. Equal to the one-process analyzer from output
    step p onward.
    """
    group, n, _ = time_ring(mesh)
    _, recv, _ = _start_to_channels(sharded_channelize(ch, x_local, mesh), group, n)
    return _join(recv)


def sharded_channelize_fm_to_channels(ch: Firpfbch, kf: float, x_local: torch.Tensor,
                                      mesh: DeviceMesh) -> torch.Tensor:
    """Config[4] with channel-parallel demod: channelize (time-sharded) →
    ``all_to_all`` → FM-discriminate each channel group on its rank.

    Each rank holds its channels' whole stream after the redistribution, so
    the discriminator has no block seams: [M/n, n·t_loc − 1], exact past
    the leading zero-state transient, with no extra halo.
    """
    return _discriminate(sharded_channelize_to_channels(ch, x_local, mesh), _fm_ref(kf))


def sharded_channelize_fm(ch: Firpfbch, kf: float, x_local: torch.Tensor,
                          mesh: DeviceMesh) -> torch.Tensor:
    """Config[4] workload: channelize + per-channel FM discriminator.

    The discriminator m[n] = arg(conj(y[n−1])·y[n])/(2π·kf) needs one earlier
    channel sample, so this path takes a halo one step larger, (p+1)·M
    samples: it keeps steps p.. of ``[halo | block]``, step p being the
    discriminator's memory. Returns [M, t_loc]; no second collective.
    """
    M, p = ch.num_channels, ch.p
    lead = halo_exchange_left(x_local, (p + 1) * M, mesh)
    y, _ = ch.analyzer_execute(torch.cat([lead, x_local], dim=-1))
    return _discriminate(y[..., p:], _fm_ref(kf))


class _FmDemod:
    """Per-channel FM discriminator with cross-block memory (config[4])."""

    def __init__(self, kf: float):
        self.ref = _fm_ref(kf)

    def init(self, y0: torch.Tensor, n: int) -> torch.Tensor:
        """The discriminator's memory before the stream: zeros, one sample a
        channel of this rank's group after the redistribution."""
        return torch.zeros_like(y0[: y0.shape[0] // n, :1])

    def apply(self, yg: torch.Tensor, prev: torch.Tensor):
        return _discriminate(torch.cat([prev, yg], dim=-1), self.ref), yg[..., -1:]


def _stream_local_pipeline(ch: Firpfbch, blocks: torch.Tensor, mesh: DeviceMesh,
                           demod: _FmDemod | None = None) -> torch.Tensor:
    """The double-buffered streaming channelizer, on this rank's blocks
    [B, t_loc·M]; returns [B, M/n, n·t_loc].

    Halo continuity across the stream: rank r's block-i halo is the tail of
    rank r−1's block i; rank 0's is the tail of rank n−1's block i−1, which
    that rank carried: one cyclic exchange a block, where the last rank
    sends its carried tail and every other rank its current one. At n = 1
    that is a send to itself, taken locally (NCCL and gloo do not both take
    one). The stream starts from zero state, as the one-process
    analyzer does.

    Overlap: block i−1's ``all_to_all`` is issued (``async_op=True``) before
    block i's analyzer and waited for only before block i−1's demod, so the
    collective runs while the analyzer computes. It is the counterpart of
    yagi_tpu's scanned pipeline, whose ``all_to_all`` reads the loop carry
    (the previous block's output) and so has no data dependence on the
    analyzer of its iteration. Block i's halo is exchanged first: on NCCL
    the p2p and the collective of one group share a stream, and the halo
    behind the ``all_to_all`` would hold the analyzer back.
    """
    M, p = ch.num_channels, ch.p
    halo = p * M
    group, n, r = time_ring(mesh)

    def lead_of(blk, carried):
        mine = tail(blk, halo)
        send = carried if r == n - 1 else mine
        if n == 1:
            return send, mine
        lead = torch.empty_like(send)
        exchange(group, send, (r + 1) % n, lead, (r - 1) % n)
        return lead, mine

    def analyze(lead, blk):
        y, _ = ch.analyzer_execute(torch.cat([lead, blk], dim=-1))
        return y[..., p:]

    n_blk = blocks.shape[0]
    lead, carried = lead_of(blocks[0], torch.zeros_like(tail(blocks[0], halo)))
    y = analyze(lead, blocks[0])
    dstate = demod.init(y, n) if demod is not None else None
    outs = []
    for i in range(n_blk):
        if i + 1 < n_blk:
            lead, next_carried = lead_of(blocks[i + 1], carried)  # block i+1's halo
        work, recv, _send = _start_to_channels(y, group, n, async_op=True)  # block i
        if i + 1 < n_blk:
            y, carried = analyze(lead, blocks[i + 1]), next_carried  # block i+1, meanwhile
        work.wait()
        out = _join(recv)
        if demod is not None:
            out, dstate = demod.apply(out, dstate)
        outs.append(out)
    return torch.stack(outs)


def sharded_channelize_stream_to_channels(ch: Firpfbch, blocks: torch.Tensor,
                                          mesh: DeviceMesh) -> torch.Tensor:
    """Double-buffered streaming channelizer (BASELINE config[4] structure).

    ``blocks``: this rank's part [B, t_loc·M] of B consecutive time blocks
    of one stream, each time-sharded over ``"time"``. Returns this rank's
    channel group [B, M/n, T] (T = n·t_loc steps a block), equal to the
    one-process ``ch.analyzer_execute`` over the concatenated stream past
    the stream's zero-state transient, with block i's ``all_to_all``
    overlapping block i+1's analyzer (see :func:`_stream_local_pipeline`).
    """
    return _stream_local_pipeline(ch, blocks, mesh)


def sharded_channelize_stream_fm_to_channels(ch: Firpfbch, kf: float, blocks: torch.Tensor,
                                             mesh: DeviceMesh) -> torch.Tensor:
    """Streaming config[4]: pipelined channelize → all_to_all → FM demod.

    As :func:`sharded_channelize_stream_to_channels`, each redistributed
    block FM-discriminated on its rank with the one-sample discriminator
    memory carried across blocks: the stream's first output uses zero
    memory, every later block boundary is seamless. [B, M/n, T].
    """
    return _stream_local_pipeline(ch, blocks, mesh, demod=_FmDemod(kf))
