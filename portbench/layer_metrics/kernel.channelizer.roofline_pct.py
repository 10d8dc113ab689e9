"""K2 (``csrc/channelizer.cu``, either instance): the least time of the
channelizer's work (``work/channelizer.py``) over its device time a call in
the trace, in %."""


def read(rec):
    return rec.roofline_pct(r"\bchannelizer_(fp32|tiled)_kernel\b", "channelizer")
