"""Host-side buffer objects with reference semantics (NumPy-backed).

Copied from :mod:`yagi_tpu.buffer.buffer`:

Window     — sliding window with contiguous ``read()`` view (the
             reference's buffer/window.rs:4-90).
WDelay     — fixed delay line (buffer/wdelay.rs:4-58).
CBuffer    — circular buffer with push/write/pop/read/release (liquid-dsp
             cbuffer; the reference marks it "missing", buffer/mod.rs:5).

dtype is whatever the first pushed value promotes to (callers pass
``dtype=`` for exact control, matching the reference's `f32`/`Complex32`
instantiations).
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError, ValueRangeError

__all__ = ["Window", "WDelay", "CBuffer"]


class Window:
    """Sliding window: keeps the most recent ``n`` samples, oldest first.

    Matches the reference's observable behavior (window.rs): zeros at reset,
    ``push`` appends newest at the end, ``read`` returns the n samples with
    index 0 = oldest, ``resize`` keeps the latest samples (zero-padding in
    front when growing). The power-of-2 shadow buffer of the reference is an
    amortization trick, not semantics — a flat roll is fine host-side.
    """

    def __init__(self, n: int, dtype=np.float32):
        if n == 0:
            raise ConfigError("window size must be greater than zero")
        self.len = int(n)
        self.dtype = np.dtype(dtype)
        self.v = np.zeros(self.len, dtype=self.dtype)

    def reset(self) -> None:
        self.v[:] = 0

    def read(self) -> np.ndarray:
        """Contiguous snapshot, index 0 = oldest (window.rs:66-68).

        Returns a copy: the reference hands out an immutable borrow, so a
        returned buffer must neither mutate on the next push() nor allow the
        caller to corrupt window state by writing into it.
        """
        return self.v.copy()

    def index(self, i: int):
        """i-th element, 0 = oldest (window.rs:70-75)."""
        if not 0 <= i < self.len:
            raise ValueRangeError("index value out of range")
        return self.v[i]

    def push(self, value) -> None:
        self.v[:-1] = self.v[1:]
        self.v[-1] = value

    def write(self, values) -> None:
        for value in np.asarray(values).ravel():
            self.push(value)

    def resize(self, n: int) -> None:
        """Keep the latest samples; zero-pad in front when growing
        (window.rs:34-58)."""
        if n == 0:
            raise ConfigError("window size must be greater than zero")
        n = int(n)
        if n == self.len:
            return
        new = np.zeros(n, dtype=self.dtype)
        k = min(n, self.len)
        new[n - k :] = self.v[self.len - k :]
        self.v = new
        self.len = n


class WDelay:
    """Fixed delay line: ``push`` newest, ``read`` the sample from ``delay``
    pushes ago (zeros until primed) — wdelay.rs:10-58."""

    def __init__(self, delay: int, dtype=np.float32):
        if delay == 0:
            raise ConfigError("delay must be greater than zero")
        self.delay = int(delay)
        self.dtype = np.dtype(dtype)
        self.v = np.zeros(self.delay + 1, dtype=self.dtype)
        self.read_index = 0

    def reset(self) -> None:
        self.v[:] = 0
        self.read_index = 0

    def read(self):
        return self.v[self.read_index]

    def push(self, value) -> None:
        self.v[self.read_index] = value
        self.read_index = (self.read_index + 1) % (self.delay + 1)

    def recreate(self, delay: int) -> None:
        """Change the delay, preserving history (wdelay.rs:27-44)."""
        if delay == self.delay:
            return
        hist = np.array(
            [self.v[(i + self.read_index) % (self.delay + 1)]
             for i in range(self.delay + 1)],
            dtype=self.dtype,
        )
        self.__init__(delay, dtype=self.dtype)
        for value in hist:
            self.push(value)


class CBuffer:
    """Circular buffer (liquid cbuffer semantics; absent from the reference).

    ``push``/``write`` append up to ``max_size`` elements; ``read(n)``
    returns the oldest ``n`` without consuming; ``release(n)`` consumes;
    ``pop`` reads+consumes one. Overflow raises (liquid returns an error
    code from ``cbuffer_push`` when full).
    """

    def __init__(self, max_size: int, dtype=np.float32):
        if max_size == 0:
            raise ConfigError("buffer size must be greater than zero")
        self.max_size = int(max_size)
        self.dtype = np.dtype(dtype)
        self.v = np.zeros(self.max_size, dtype=self.dtype)
        self.head = 0  # index of oldest element
        self.count = 0

    # ------------------------------------------------------------- inspect
    def size(self) -> int:
        return self.count

    def space_available(self) -> int:
        return self.max_size - self.count

    def is_full(self) -> bool:
        return self.count == self.max_size

    def reset(self) -> None:
        self.head = 0
        self.count = 0

    # -------------------------------------------------------------- mutate
    def push(self, value) -> None:
        if self.count == self.max_size:
            raise ValueRangeError("cannot push onto full buffer")
        self.v[(self.head + self.count) % self.max_size] = value
        self.count += 1

    def write(self, values) -> None:
        values = np.asarray(values).ravel()
        if values.size > self.space_available():
            raise ValueRangeError("cannot write more elements than are available")
        for value in values:
            self.push(value)

    def read(self, n: int) -> np.ndarray:
        """Oldest ``n`` elements without consuming them."""
        if n < 0:
            raise ValueRangeError("read count must be non-negative")
        n = min(int(n), self.count)
        idx = (self.head + np.arange(n)) % self.max_size
        return self.v[idx]

    def release(self, n: int) -> None:
        if not 0 <= n <= self.count:
            raise ValueRangeError("cannot release more elements than are in the buffer")
        self.head = (self.head + n) % self.max_size
        self.count -= n

    def pop(self):
        if self.count == 0:
            raise ValueRangeError("cannot pop from empty buffer")
        out = self.v[self.head]
        self.release(1)
        return out
