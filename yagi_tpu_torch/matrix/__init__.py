"""Matrix operations (reference layer L0: src/matrix/), host-side NumPy."""

from .dense import (  # noqa: F401
    matrix_add,
    matrix_sub,
    matrix_mul,
    matrix_aug,
    matrix_det,
    matrix_trans,
    matrix_hermitian,
    matrix_transmul,
    matrix_mul_transpose,
    matrix_mul_hermitian,
    matrix_inv,
    matrix_ludecomp_crout,
    matrix_ludecomp_doolittle,
    matrix_qrdecomp_gramschmidt,
    matrix_chol,
    matrix_linsolve,
    matrix_cgsolve,
    matrix_gramschmidt,
)
from .sparse import SMatrix  # noqa: F401
