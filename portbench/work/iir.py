"""``iir_chunked`` (``csrc/iir.cu``) over config[2]'s de-emphasis, a
first-order transfer function (b = [α, 0], a = [1, −(1 − α)]) on [C, T]
float32 samples a call: bytes C·T·4 in and out, the state (``ORDER`` values a
channel) in and out and the coefficients, each once; operations 2·(order +
1) a sample, a multiply and an add for each coefficient."""

ORDER = 1  # the de-emphasis's order


def work(cfg: dict, wl: dict, info: dict):
    c, t = cfg["channels"], wl["block"]
    nbytes = 2 * c * t * 4 + 2 * c * ORDER * 4 + (2 * (ORDER + 1) + 1) * 4
    return float(nbytes), float(2 * (ORDER + 1) * c * t)
