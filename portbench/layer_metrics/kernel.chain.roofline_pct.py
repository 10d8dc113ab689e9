"""K1 (``csrc/chain.cu``): the least time of the chain's work
(``work/chain.py``) over its device time a call in the trace, in %."""


def read(rec):
    return rec.roofline_pct(r"\bchain_kernel\b", "chain")
