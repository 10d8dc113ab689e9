"""The AGC's function (``agc_scan``) over [C, n] complex64 samples
(chip_smoke.py:3837-3838): the samples in and out, the eight per-channel
state and parameter words in and out; per sample ~12 operations, an exp and
a log."""


def work(cfg: dict, wl: dict, info: dict):
    c, n = cfg["channels"], wl["block"]
    return float(c * n * 8 * 2 + c * 4 * 8 * 2), float(c * n * 14)
