"""The receive chain's function (K1): FIR → P× polyphase interpolation → NCO
mix-down over [C, T] complex64 samples.

Bytes: the input [C, T] and output [C, T·P] complex64, the P combined
filters of n_taps + 2m − 1 taps (float32) and the [C, 128] history planes
read once. Operations: per input sample the FIR's 2·n_taps real MACs on
complex data; per output a branch's 2m complex-by-real MACs, the rotation,
its sine and cosine (chip_smoke.py:3807-3808, 3813-3816)."""


def work(cfg: dict, wl: dict, info: dict):
    c, t, p = cfg["channels"], wl["block"], int(cfg["rate"])
    n_taps, pfb = cfg["n_taps"], 2 * cfg["m"]
    taps = p * (n_taps + pfb - 1) * 4
    hist = 2 * c * 128 * 4
    nbytes = 4 * c * t * 2 * (1 + p) + taps + hist
    ops = c * t * (4 * n_taps + p * (4 * pfb + 8))
    return float(nbytes), float(ops)
