"""``agc_scan`` (``csrc/agc.cu``): the least time of the AGC's work
(``work/agc.py``) over its device time a call in the trace, in %."""


def read(rec):
    return rec.roofline_pct(r"\bagc_scan_kernel\b", "agc")
