"""``fir_block`` (``csrc/fir.cu``) over config[2]'s four FIRs, each a call on
[C, T] samples through ``n_taps`` taps: the mean over the four calls of the
least work each needs. Operations: 2·C·T·L·r a call, r the real
multiply-adds a tap of its least form: 2 for the pilot's bandpass (its
signal is the real composite, its taps complex), 1 for the delay, 1 for the
sum's lowpass, 2 for the difference's (the complex mix through real taps).
Bytes: the block in and the L − 1 samples of the window before it, the
output and the taps, each once (4 bytes a real value, 8 a complex one). No
implementation of the same four functions does less, so the share cannot
pass 100%."""

# (signal complex, taps complex) of the pilot, the delay, the sum, the difference
FILTERS = ((False, True), (False, False), (False, False), (True, False))


def work(cfg: dict, wl: dict, info: dict):
    c, t, L = cfg["channels"], wl["block"], cfg["n_taps"]
    nbytes = ops = 0
    for xc, hc in FILTERS:
        sx, sy, sh = 8 if xc else 4, 8 if xc or hc else 4, 8 if hc else 4
        nbytes += c * (t + L - 1) * sx + c * t * sy + L * sh
        ops += 2 * c * t * L * (2 if xc or hc else 1)
    return nbytes / len(FILTERS), ops / len(FILTERS)
