"""The symbol synchronizer's function (K3) at E slots a sample over [C, n]
complex64 samples, L taps a branch, P branches (chip_smoke.py:3802-3812).

Bytes: the window-prefixed samples [C, n + L], the matched and derivative
banks [2P, L] float32, per slot its complex64 value and its valid byte, the
9-row state in and out, the deferral count. Operations: per emission the
selected branch's four L-tap dots (8·L), per slot ~20 loop operations. The
emissions depend on the data: ``info["emitted_per_block"]``, counted by the
reference on the compared window blocks; without it, no count."""


def work(cfg: dict, wl: dict, info: dict):
    emitted = info.get("emitted_per_block")
    if emitted is None:
        return None
    c, n, P, E = cfg["channels"], wl["block"], cfg["npfb"], cfg["slots"]
    L = (2 * cfg["k"] * P * cfg["m"] + 1) // P
    nbytes = c * (n + L) * 8 + 2 * P * L * 4 + c * n * E * 9 + c * 9 * 4 * 2 + c * 4
    ops = emitted * 8 * L + c * n * E * 20
    return float(nbytes), float(ops)
