#!/usr/bin/env python
"""One rank of a multi-process streaming run of ``yagi_tpu_torch.parallel``.

Started once a rank (a card, or a CPU process with gloo), configured by
environment variables:

  MULTIHOST_COORD   rendezvous: host:port, tcp://host:port or file:///path;
                    unset, torchrun's environment (RANK, WORLD_SIZE, ...)
  MULTIHOST_N       number of ranks (with MULTIHOST_COORD)
  MULTIHOST_ID      this rank (with MULTIHOST_COORD)
  MULTIHOST_DEVICE  "cpu" for gloo on the CPU; unset, the card over NCCL
  MULTIHOST_CH      channel groups of the FIR's ("ch", "time") mesh (default 1)
  MULTIHOST_OUT     optional: rank 0 writes every gathered output to this .npz

Each rank takes its own block of a seeded stream, runs the sharded
functions, and gathers their outputs to every rank. Rank 0 checks them bit
for bit against the one-process sequential computation and prints, each on
a line: ``MULTIHOST_OK`` (``time_sharded_fir``, with and without history),
``MULTIHOST_CHANNELIZER_OK`` (the six channelizer functions at M = 64,
their halos crossing every rank boundary, the ``all_to_all`` carrying the
channels) and ``MULTIHOST_PIPELINED_STREAM_OK`` (the double-buffered stream
with the FM discriminator's memory carried across blocks).

On the CPU, four ranks (the tests in ``tests/test_torch_multihost.py`` and
``tests/test_torch_parallel.py`` start them)::

    for i in 0 1 2 3; do MULTIHOST_COORD=file:///tmp/rdv MULTIHOST_N=4 \\
      MULTIHOST_ID=$i MULTIHOST_DEVICE=cpu OMP_NUM_THREADS=1 \\
      python -m yagi_tpu_torch.tools.multihost_worker & done; wait

and over the cards of one host, one rank a card on NCCL::

    torchrun --nproc-per-node=4 yagi_tpu_torch/tools/multihost_worker.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

FIR_CH, FIR_TAPS, FIR_STEP = 4, 33, 64  # channels, taps, samples a time rank
# channelizer: channels, steps a rank, blocks, FM kf. Rows of whole multiples
# of 32 samples: on the CPU, ATen's vectorized atan2 and its scalar remainder
# loop differ by an ulp, so the FM outputs equal the one-process ones bit for
# bit only where no row ends in a remainder (no such split on the card)
M, STEPS, B, KF = 64, 32, 3, 0.1


def _complex(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from yagi_tpu_torch.errors import ConfigError
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
    from yagi_tpu_torch.parallel.multihost import (
        distribute_time_stream,
        gather_to_hosts,
        global_time_mesh,
        initialize_multihost,
    )

    dev = os.environ.get("MULTIHOST_DEVICE")
    backend = "gloo" if dev == "cpu" else None
    if "MULTIHOST_COORD" in os.environ:
        initialize_multihost(os.environ["MULTIHOST_COORD"], int(os.environ["MULTIHOST_N"]),
                             int(os.environ["MULTIHOST_ID"]), backend=backend)
    else:
        initialize_multihost(backend=backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}

    # ---- the mesh shapes, and n_devices that is not the world ------------
    for ch in (1, 2, 3):
        out[f"mesh_shape_ch{ch}"] = np.asarray(make_stream_mesh(world, ch=ch, device_type=dev).shape)
    try:
        make_stream_mesh(world + 1, device_type=dev)
        out["bad_n_devices_raised"] = np.asarray(False)
    except ConfigError as e:
        out["bad_n_devices_raised"] = np.asarray(f"n_devices={world + 1}" in str(e))

    # ---- FIR on the ("ch", "time") mesh, with and without history ---------
    mesh = global_time_mesh(int(os.environ.get("MULTIHOST_CH", "1")), device_type=dev)
    n_ch, n_time = mesh.shape
    c_r, t_r = mesh.get_local_rank("ch"), mesh.get_local_rank("time")
    rng = np.random.default_rng(0)
    n = n_time * FIR_STEP
    h = rng.standard_normal(FIR_TAPS).astype(np.float32)
    x = _complex(rng, (FIR_CH, n))
    hist = _complex(rng, (FIR_CH, FIR_TAPS - 1))
    c_loc = FIR_CH // n_ch
    rows = slice(c_r * c_loc, (c_r + 1) * c_loc)
    xl = distribute_time_stream(x[rows, t_r * FIR_STEP:(t_r + 1) * FIR_STEP], mesh)

    def gather_fir(y):
        y_t = gather_to_hosts(y, -1, mesh.get_group("time"))
        return gather_to_hosts(torch.from_numpy(y_t).to(y.device), 0, mesh.get_group("ch"))

    out["fir"] = gather_fir(time_sharded_fir(h, xl, mesh))
    out["fir_history"] = gather_fir(time_sharded_fir(h, xl, mesh, history=hist[rows]))
    out["fir_x"], out["fir_h"], out["fir_hist"] = x, h, hist

    # ---- halo_exchange_left over all ranks: zeros on time rank 0 ----------
    tmesh = global_time_mesh(1, device_type=dev)
    blk = distribute_time_stream(np.full((2, 8), rank + 1, np.complex64), tmesh)
    out["halo"] = gather_to_hosts(halo_exchange_left(blk, 3, tmesh), 0)

    # ---- the six channelizer functions, M = 64, on a time mesh of all ranks
    chz = Firpfbch.create_kaiser(M, 4, 60.0, device=tmesh.device_type)
    T = world * STEPS  # analyzer steps of the stream (a block, for the stream)
    xc = _complex(rng, T * M)
    xb = _complex(rng, (B, T * M))
    per = STEPS * M
    xcl = distribute_time_stream(xc[rank * per:(rank + 1) * per], tmesh)
    xbl = distribute_time_stream(np.ascontiguousarray(xb[:, rank * per:(rank + 1) * per]), tmesh)
    out["chz_x"], out["chz_blocks"] = xc, xb
    out["channelize"] = gather_to_hosts(sharded_channelize(chz, xcl, tmesh), -1)
    out["channelize_fm"] = gather_to_hosts(sharded_channelize_fm(chz, KF, xcl, tmesh), -1)
    out["to_channels"] = gather_to_hosts(sharded_channelize_to_channels(chz, xcl, tmesh), 0)
    out["fm_to_channels"] = gather_to_hosts(
        sharded_channelize_fm_to_channels(chz, KF, xcl, tmesh), 0)
    out["stream"] = gather_to_hosts(sharded_channelize_stream_to_channels(chz, xbl, tmesh), 1)
    out["stream_fm"] = gather_to_hosts(
        sharded_channelize_stream_fm_to_channels(chz, KF, xbl, tmesh), 1)

    if rank == 0:
        check(out, n_ch, n_time, world, xl.device)
        path = os.environ.get("MULTIHOST_OUT")
        if path:
            np.savez(path, **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def discriminate(y):
    """The FM discriminator's ops (``Freqdem``'s), on the one-process output."""
    ref = float(np.float32(1.0 / (2.0 * np.pi * KF)))
    return (torch.angle(y[..., :-1].conj() * y[..., 1:]) * ref).cpu().numpy()


def check(out: dict, n_ch: int, n_time: int, world: int, device) -> None:
    """Rank 0: every gathered output against the one-process sequential
    computation on the same device, bit for bit."""
    from yagi_tpu_torch.filter import FirFilter
    from yagi_tpu_torch.modem import Freqdem
    from yagi_tpu_torch.multichannel import Firpfbch

    x, hist = (torch.from_numpy(out[k]).to(device) for k in ("fir_x", "fir_hist"))
    fir = FirFilter.create(out["fir_h"], batch_shape=(FIR_CH,), dtype=torch.complex64,
                           device=device)
    for key, f in (("fir", fir), ("fir_history", fir.write(hist))):
        parts = []
        for b in range(n_time):
            y, f = f.execute_block(x[:, b * FIR_STEP:(b + 1) * FIR_STEP])
            parts.append(y)
        np.testing.assert_array_equal(out[key], torch.cat(parts, dim=-1).cpu().numpy())
    print(f"MULTIHOST_OK procs={world} mesh=({n_ch}, {n_time})", flush=True)

    def analyze(xs):
        return Firpfbch.create_kaiser(M, 4, 60.0, device=device).analyzer_execute(
            torch.from_numpy(xs).to(device))[0]

    p, T = Firpfbch.create_kaiser(M, 4, 60.0, device=device).p, world * STEPS
    ref = analyze(out["chz_x"])
    for key in ("channelize", "to_channels"):
        assert out[key].shape == (M, T), (key, out[key].shape)
        np.testing.assert_array_equal(out[key][:, p:], ref[:, p:].cpu().numpy())
    assert out["fm_to_channels"].shape == (M, T - 1)
    np.testing.assert_array_equal(out["fm_to_channels"][:, p:], discriminate(ref)[:, p:])
    # channelize_fm[:, g] is the pair (g−1, g): Firpfbch → Freqdem block by
    # block, each block a rank's; the first p + 1 steps are rank 0's
    # zero-state transient
    chz, dem, parts = (Firpfbch.create_kaiser(M, 4, 60.0, device=device),
                       Freqdem.create(KF, batch_shape=(M,), device=device), [])
    for b in range(world):
        y, chz = chz.analyzer_execute(torch.from_numpy(out["chz_x"]).to(device)[
            b * STEPS * M:(b + 1) * STEPS * M])
        m, dem = dem.demodulate(y)
        parts.append(m)
    assert out["channelize_fm"].shape == (M, T)
    np.testing.assert_array_equal(out["channelize_fm"][:, p + 2:],
                                  torch.cat(parts, dim=-1)[:, p + 2:].cpu().numpy())
    print(f"MULTIHOST_CHANNELIZER_OK M={M} T={T} procs={world}", flush=True)

    yb = analyze(out["chz_blocks"].reshape(-1))
    y_ref = yb.reshape(M, B, T).permute(1, 0, 2).cpu().numpy()
    m_ref = discriminate(torch.cat([torch.zeros_like(yb[:, :1]), yb], dim=-1))
    m_ref = m_ref.reshape(M, B, T).transpose(1, 0, 2)
    for key, want, skip in (("stream", y_ref, p), ("stream_fm", m_ref, p + 1)):
        assert out[key].shape == (B, M, T), (key, out[key].shape)
        np.testing.assert_array_equal(out[key][0][:, skip:], want[0][:, skip:])
        np.testing.assert_array_equal(out[key][1:], want[1:])
    print(f"MULTIHOST_PIPELINED_STREAM_OK B={B} M={M} T={T} procs={world}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
