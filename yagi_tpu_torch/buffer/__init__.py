"""Buffers: sliding window, delay line, circular buffer (reference layer L1).

Host-side objects (the reference's buffer/window.rs, buffer/wdelay.rs, and
liquid-dsp's cbuffer). The streaming objects of the port do not use them:
each carries its window as an ``[..., n]`` tensor, rolled once a block.
"""

from .buffer import CBuffer, WDelay, Window

__all__ = ["Window", "WDelay", "CBuffer"]
