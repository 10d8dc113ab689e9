"""``iir_chunked`` (``csrc/iir.cu``): the least time of the de-emphasis's
work (``work/iir.py``) over the kernel's device time a call in the trace,
in %."""


def read(rec):
    return rec.roofline_pct(r"\biir_chunked_kernel\b", "iir")
