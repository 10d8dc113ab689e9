"""Sparse matrix (row adjacency dicts), host-side NumPy.

Copied from :mod:`yagi_tpu.matrix.sparse` (the reference's matrix/sparse.rs):
SMatrix<T> for bool/f32/i16 with set/get/isset/delete/eye, matrix-matrix
mul, and matrix-vector vmul (incl. the boolean mod-2 variants,
sparse.rs:418-479). These back FEC interleavers and codes, not the sample
path.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = ["SMatrix"]


class SMatrix:
    """Sparse matrix as per-row dicts (sparse.rs:33-43)."""

    def __init__(self, m: int, n: int, dtype=np.float32):
        if m == 0 or n == 0:
            raise ConfigError("dimensions must be greater than zero")
        self.m = m
        self.n = n
        self.dtype = np.dtype(dtype)
        self.rows: list[dict[int, float]] = [dict() for _ in range(m)]

    @classmethod
    def from_array(cls, v, dtype=None) -> "SMatrix":
        """Dense → sparse (sparse.rs:68)."""
        v = np.asarray(v)
        if dtype is None:
            dtype = v.dtype
        out = cls(v.shape[0], v.shape[1], dtype)
        for i in range(v.shape[0]):
            for j in range(v.shape[1]):
                if v[i, j] != 0:
                    out.set(i, j, v[i, j])
        return out

    def size(self) -> tuple[int, int]:
        return (self.m, self.n)

    def clear(self) -> None:
        """Remove all entries (sparse.rs:168)."""
        self.rows = [dict() for _ in range(self.m)]

    reset = clear

    def isset(self, i: int, j: int) -> bool:
        self._check(i, j)
        return j in self.rows[i]

    def set(self, i: int, j: int, v) -> None:
        self._check(i, j)
        if v == 0:
            self.rows[i].pop(j, None)
        else:
            self.rows[i][j] = self.dtype.type(v)

    def get(self, i: int, j: int):
        self._check(i, j)
        return self.rows[i].get(j, self.dtype.type(0))

    def delete(self, i: int, j: int) -> None:
        self._check(i, j)
        self.rows[i].pop(j, None)

    def eye(self) -> None:
        """Set to identity (sparse.rs:312)."""
        self.clear()
        for i in range(min(self.m, self.n)):
            self.set(i, i, 1)

    def _check(self, i: int, j: int) -> None:
        if i >= self.m or j >= self.n:
            raise ConfigError("index out of range")

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=self.dtype)
        for i, row in enumerate(self.rows):
            for j, v in row.items():
                out[i, j] = v
        return out

    def mul(self, other: "SMatrix") -> "SMatrix":
        """Sparse×sparse product (sparse.rs:324)."""
        if self.n != other.m:
            raise ConfigError("inner dimensions must match")
        out = SMatrix(self.m, other.n, self.dtype)
        for i, row in enumerate(self.rows):
            acc: dict[int, float] = {}
            for k, v in row.items():
                for j, w in other.rows[k].items():
                    acc[j] = acc.get(j, 0) + v * w
            for j, v in acc.items():
                if v != 0:
                    out.set(i, j, v)
        return out

    def vmul(self, x) -> np.ndarray:
        """Matrix-vector product (sparse.rs:384)."""
        x = np.asarray(x)
        if len(x) != self.n:
            raise ConfigError("vector length must match columns")
        y = np.zeros(self.m, dtype=np.result_type(self.dtype, x.dtype))
        for i, row in enumerate(self.rows):
            y[i] = sum(v * x[j] for j, v in row.items())
        return y

    def vmul_bool(self, x) -> np.ndarray:
        """Boolean (mod-2) matrix-vector product (sparse.rs:458-479)."""
        x = np.asarray(x).astype(np.uint8)
        y = np.zeros(self.m, dtype=np.uint8)
        for i, row in enumerate(self.rows):
            y[i] = np.uint8(sum(int(x[j]) for j in row.keys()) & 1)
        return y
