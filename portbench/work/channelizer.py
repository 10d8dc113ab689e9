"""The channelizer's function (K2) over a block of T analyzer steps of M = 64
channels, p taps a branch (chip_smoke.py:3912, ``channelizer_fp32``).

Bytes: the wideband planes in and the channel planes out (float32, 2·T·M
each way), the taps [p, 128], the history planes (halo rows of 128 samples
each) and the scale, each once. Operations: per step M branches of p
complex-by-real MACs (4 real operations each) and a radix-2 M-point FFT
(5·M·log2 M)."""

import math


def work(cfg: dict, wl: dict, info: dict):
    m, t, p = cfg["channels"], wl["block"], 2 * cfg["m"]
    halo = max((p + 1) // 2, (p - 1) // 2 + 1)  # kernels/channelizer.py::halo_rows
    nbytes = 2 * 4 * t * m * 2 + p * 128 * 4 + 2 * halo * 128 * 4 + 4
    ops = t * (m * p * 4 + 5 * m * int(math.log2(m)))
    return float(nbytes), float(ops)
