"""``fir_block_kernel`` (``csrc/fir.cu``): the least time of config[2]'s FIR
work a call (``work/fir.py``, the mean of its four filters) over the
kernel's mean device time a call in the trace, in %. None where the trace
has no such kernel (a program before it)."""


def read(rec):
    return rec.roofline_pct(r"\bfir_block_kernel\b", "fir")
