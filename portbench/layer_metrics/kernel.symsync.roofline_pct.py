"""K3 (``csrc/symscan.cu``, fused): the least time of the synchronizer's
work (``work/symsync.py``, emissions counted by the reference) over its
device time a call in the trace, in %."""


def read(rec):
    return rec.roofline_pct(r"\bsymsync_fused_kernel\b", "symsync")
