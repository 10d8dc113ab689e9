"""The equalizer and carrier loop's function (``qam_eq_scan``) over S = E·n
slots of C channels, h_len taps, an M-point table (chip_smoke.py:3803-3805,
3840-3843).

Bytes: the slots (complex64) and their valid bytes in; the symbols
(8 bytes), soft outputs (complex64) and mask bytes out; the loop state in and
out (w and the window complex64, |x|² float32 per tap, seven scalars a
channel); the table; mu, α and β. Operations per slot: the h_len-tap complex
dot (8·h_len), the M distances (5·M), the LMS update (10·h_len) and ~30 of
PLL and derotation."""


def work(cfg: dict, wl: dict, info: dict):
    c, E, h = cfg["channels"], cfg["slots"], cfg["eq_len"]
    m = int(cfg["scheme"][3:])  # points of the square QAM table
    S = E * wl["block"]
    eq_state = c * (8 * h + 8 * h + 4 * h + 7 * 4)
    nbytes = c * S * (8 + 1 + 8 + 8 + 1) + 2 * eq_state + m * 8 + c * 3 * 4
    ops = c * S * (8 * h + 5 * m + 10 * h + 30)
    return float(nbytes), float(ops)
