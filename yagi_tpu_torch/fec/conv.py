"""Convolutional codes and their Viterbi decoder.

Port of :mod:`yagi_tpu.fec.conv` (behavioral spec: liquid-dsp's
convolutional set, LIQUID_COMPAT.md fec rows): the ka9q codes V27 (K=7,
r=1/2), V29 (K=9, r=1/2), V39 (K=9, r=1/3), V615 (K=15, r=1/6), plus
punctured rates p/(p+1) for p in 2..7 on the K=7 and K=9 base codes.

Where each part runs:

- **Encode** is packet-rate bit work on the host in numpy, as in yagi_tpu:
  output stream j is ``convolve(x, g_j) & 1``.
- **Decode**, the Viterbi decoder that yagi_tpu runs as a ``lax.scan``,
  runs in torch on the code's device (:func:`viterbi`): one
  add-compare-select over all 2^(K-1) path metrics a trellis step, the
  decisions ``[T, S]`` kept on the device, then a reverse walk from state 0
  on the device (one gather a step from every step's predecessor table,
  formed at once); the decoded bits come to the host once. Its arithmetic is
  yagi_tpu's, so the decoded bits are the same bit for bit: float32
  metrics, 1e9 for every state but 0 at the start, the branch metric
  ``|r − expected|`` summed over the R outputs in order, a strict ``<``
  (ties go to the first predecessor), renormalized by the minimum each
  step. Soft-decision input: each received level in [0,1] (0.5 = erasure,
  which is how punctured positions are filled).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError

__all__ = [
    "ConvCode", "PuncturedConvCode", "conv27", "conv29", "conv39", "conv615",
    "conv_punctured",
]

# ka9q / liquid generator polynomials (bit i of poly taps x[n-i])
_V27_POLYS = (0x6D, 0x4F)
_V29_POLYS = (0x1AF, 0x11D)
_V39_POLYS = (0x1ED, 0x19B, 0x127)
_V615_POLYS = (0o42631, 0o47245, 0o56507, 0o73363, 0o77267, 0o64537)


def _parity(v: np.ndarray, bits: int) -> np.ndarray:
    """Parity of the low ``bits`` bits of each integer."""
    p = np.zeros_like(v)
    for i in range(bits):
        p ^= (v >> i) & 1
    return p


def puncture_mask(p: int, T: int) -> np.ndarray:
    """[T, 2] kept positions of a punctured rate-1/2 stream: output A always,
    output B on phase 0 of each period p."""
    keep = np.ones((p, 2), dtype=bool)
    keep[1:, 1] = False
    return np.tile(keep, (-(-T // p), 1))[:T]


def levels_tensor(levels, device) -> torch.Tensor:
    """Received levels as a flat float32 tensor on ``device``."""
    if not isinstance(levels, torch.Tensor):
        levels = torch.from_numpy(np.asarray(levels, dtype=np.float32))
    return levels.to(device=device, dtype=torch.float32).reshape(-1)


def viterbi(levels: torch.Tensor, expected: torch.Tensor) -> torch.Tensor:
    """All-states add-compare-select over the T steps, then the traceback.

    levels   [T, R] float32 soft received levels
    expected [S, 2, R] float32 expected output bits per (prev state, input)

    Returns the decoded bits [T] (int64), on the levels' device. The next
    state of previous state p on input b is ((p << 1) | b) mod S, so next
    state ns = 2j + b has the predecessors j and j + S/2: viewed as
    ``[2, S/2, 2]``, the metrics of a step and its branch metrics line up
    with no gather.
    """
    T, R = levels.shape
    S = expected.shape[0]
    half = S >> 1
    # every step's branch metrics at once: bm[t, p, b] = Σ_j |r[t, j] − e[p, b, j]|
    bm = (levels[:, None, None, 0] - expected[..., 0]).abs()
    for j in range(1, R):
        bm = bm + (levels[:, None, None, j] - expected[..., j]).abs()
    bm = bm.view(T, 2, half, 2)
    m = torch.full((S,), 1e9, dtype=torch.float32, device=levels.device)
    m[0] = 0.0
    decisions = torch.empty((T, S), dtype=torch.bool, device=levels.device)
    for t in range(T):
        cand = (m.view(2, half, 1) + bm[t]).view(2, S)
        torch.lt(cand[1], cand[0], out=decisions[t])  # strict: ties keep prev0
        new = torch.minimum(cand[0], cand[1])
        m = new - new.min()  # renormalize to avoid drift
    # traceback from state 0: the state before step t is
    # prev[t, s] = (s >> 1) + take1[t, s]·S/2 (every step's table at once),
    # and step t decoded the bit s & 1
    ns = torch.arange(S, dtype=torch.int64, device=levels.device)
    prev = (ns >> 1) + decisions.to(torch.int64) * half
    states = torch.zeros(T, dtype=torch.int64, device=levels.device)
    for t in range(T - 1, 0, -1):
        torch.index_select(prev[t], 0, states[t: t + 1], out=states[t - 1: t])
    return states & 1


class ConvCode:
    """Rate-1/R, constraint-length-K convolutional code; its Viterbi
    decoder runs on ``device`` (the current CUDA device by default)."""

    def __init__(self, K: int, polys, name: str, device=None):
        self.K = int(K)
        self.polys = tuple(int(p) for p in polys)
        self.R = len(self.polys)
        self.name = name
        self.rate = 1.0 / self.R
        for p in self.polys:
            if p >= (1 << self.K):
                raise ConfigError(f"poly {p:#o} exceeds constraint length {K}")
        self.device = resolve_device(device)
        S = 1 << (self.K - 1)
        # expected outputs for (prev_state p, input b): full = (p<<1)|b
        full = ((np.arange(S)[:, None] << 1) | np.arange(2)[None, :])  # [S,2]
        outs = np.zeros((S, 2, self.R), dtype=np.float32)
        for j, poly in enumerate(self.polys):
            outs[:, :, j] = _parity(full & poly, self.K)
        self._expected = torch.from_numpy(outs).to(self.device)  # [S, 2, R]

    # ---------------- encode ----------------

    def encode_bits(self, bits) -> np.ndarray:
        """Data bits [L] -> coded bits [R*(L+K-1)] (K-1 flush zeros),
        outputs interleaved per input bit (ka9q order A,B,...)."""
        bits = np.asarray(bits, dtype=np.uint8).ravel() & 1
        L = bits.shape[0]
        T = L + self.K - 1
        out = np.zeros((T, self.R), dtype=np.uint8)
        for j, poly in enumerate(self.polys):
            g = ((poly >> np.arange(self.K)) & 1).astype(np.uint8)
            out[:, j] = np.convolve(bits, g)[:T] & 1
        return out.reshape(-1)

    # ---------------- decode ----------------

    def decode_soft(self, levels, msg_len: int) -> np.ndarray:
        """Soft-decision Viterbi on the code's device. ``levels``
        [R*(msg_len+K-1)] in [0,1] (1 = confident one, 0 = confident zero,
        0.5 = erasure), a numpy array or a tensor. Returns decoded data bits
        [msg_len] (numpy uint8)."""
        levels = levels_tensor(levels, self.device).reshape(-1, self.R)
        T = msg_len + self.K - 1
        if levels.shape[0] != T:
            raise ConfigError(
                f"received length {levels.shape[0]} != msg_len+K-1 ({T})")
        bits = viterbi(levels, self._expected)
        return bits[:msg_len].to(torch.uint8).cpu().numpy()

    def decode_bits(self, bits, msg_len: int):
        """Hard-decision decode; returns (data bits [msg_len], False)."""
        return self.decode_soft(np.asarray(bits, dtype=np.float32), msg_len), False


class PuncturedConvCode:
    """Punctured rate-p/(p+1) code over a rate-1/2 mother code.

    Puncture pattern: period p, output A always kept, output B kept only on
    phase 0 — keeping p+1 of every 2p mother bits (self-consistent
    encoder/decoder pair; punctured positions are restored as 0.5-erasures
    on the device before Viterbi, exactly the ka9q depuncture strategy).
    """

    def __init__(self, base: ConvCode, p: int, name: str):
        if base.R != 2:
            raise ConfigError("puncturing requires a rate-1/2 mother code")
        if p < 2 or p > 7:
            raise ConfigError(f"puncture period p ({p}) must be in [2,7]")
        self.base = base
        self.device = base.device
        self.p = p
        self.K = base.K
        self.name = name
        self.rate = p / (p + 1.0)

    def _mask(self, T: int) -> np.ndarray:
        return puncture_mask(self.p, T)  # [T, 2]

    def encode_bits(self, bits) -> np.ndarray:
        full = self.base.encode_bits(bits).reshape(-1, 2)
        mask = self._mask(full.shape[0])
        return full[mask]

    def decode_soft(self, levels, msg_len: int) -> np.ndarray:
        T = msg_len + self.K - 1
        kept = torch.from_numpy(np.flatnonzero(self._mask(T))).to(self.device)
        levels = levels_tensor(levels, self.device)
        if levels.shape[0] != kept.shape[0]:
            raise ConfigError(
                f"received length {levels.shape[0]} != {kept.shape[0]}")
        grid = torch.full((2 * T,), 0.5, dtype=torch.float32, device=self.device)
        grid.index_copy_(0, kept, levels)
        return self.base.decode_soft(grid, msg_len)

    def decode_bits(self, bits, msg_len: int):
        return self.decode_soft(np.asarray(bits, np.float32), msg_len), False


def conv27(device=None) -> ConvCode:
    return ConvCode(7, _V27_POLYS, "conv27", device)


def conv29(device=None) -> ConvCode:
    return ConvCode(9, _V29_POLYS, "conv29", device)


def conv39(device=None) -> ConvCode:
    return ConvCode(9, _V39_POLYS, "conv39", device)


def conv615(device=None) -> ConvCode:
    return ConvCode(15, _V615_POLYS, "conv615", device)


def conv_punctured(base_name: str, p: int, device=None) -> PuncturedConvCode:
    """liquid conv27p23..conv29p78 family: base in {conv27, conv29},
    rate p/(p+1)."""
    base = {"conv27": conv27, "conv29": conv29}.get(base_name)
    if base is None:
        raise ConfigError(f"unknown punctured base {base_name!r}")
    return PuncturedConvCode(base(device), p, f"{base_name}p{p}{p + 1}")
