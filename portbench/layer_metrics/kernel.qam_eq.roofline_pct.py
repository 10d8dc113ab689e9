"""``qam_eq_scan`` (``csrc/qam.cu``, either instance): the least time of the
equalizer and carrier loop's work (``work/qam_eq.py``) over its device time
a call in the trace, in %."""


def read(rec):
    return rec.roofline_pct(r"\bqam_eq_scan(_smem)?_kernel\b", "qam_eq")
