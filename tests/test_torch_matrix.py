"""yagi_tpu_torch.matrix on the CPU: the reference's golden fixtures
(tests/golden/matrix.npz) at TestMatrixGolden's tolerances, and every dense
function and SMatrix operation against yagi_tpu's at 1e-12 relative (both
promote to float64 for the decompositions).
"""

import numpy as np
import pytest
import torch

import yagi_tpu.matrix as jmx
import yagi_tpu_torch.matrix as tmx
from yagi_tpu_torch.errors import ConfigError

from golden_util import load

torch.set_num_threads(1)

RTOL = 1e-12


def _g(name, shape):
    return load("matrix")[name].reshape(shape)


@pytest.mark.parametrize("case", ["add", "aug", "mul", "inv", "linsolve", "cgsolve", "chol",
                                  "qr", "ludecomp", "transmul", "gramschmidt"])
def test_golden(case):
    """TestMatrixGolden's fixtures and tolerances (tests/test_aux.py:155-252)."""
    if case == "add":
        got = tmx.matrix_add(_g("MATRIXF_DATA_ADD_X", (5, 4)), _g("MATRIXF_DATA_ADD_Y", (5, 4)))
        np.testing.assert_allclose(got, _g("MATRIXF_DATA_ADD_Z", (5, 4)), atol=1e-5)
    elif case == "aug":
        got = tmx.matrix_aug(_g("MATRIXF_DATA_AUG_X", (5, 4)), _g("MATRIXF_DATA_AUG_Y", (5, 3)))
        np.testing.assert_allclose(got, _g("MATRIXF_DATA_AUG_Z", (5, 7)), atol=1e-5)
    elif case == "mul":
        got = tmx.matrix_mul(_g("MATRIXF_DATA_MUL_X", (5, 4)), _g("MATRIXF_DATA_MUL_Y", (4, 3)))
        np.testing.assert_allclose(got, _g("MATRIXF_DATA_MUL_Z", (5, 3)), atol=1e-4)
    elif case == "inv":
        got = tmx.matrix_inv(_g("MATRIXF_DATA_INV_X", (5, 5)))
        np.testing.assert_allclose(got, _g("MATRIXF_DATA_INV_Y", (5, 5)), atol=1e-3)
    elif case == "linsolve":
        got = tmx.matrix_linsolve(_g("MATRIXF_DATA_LINSOLVE_A", (5, 5)),
                                  load("matrix")["MATRIXF_DATA_LINSOLVE_B"])
        np.testing.assert_allclose(got, load("matrix")["MATRIXF_DATA_LINSOLVE_X"], atol=1e-3)
    elif case == "cgsolve":
        got = tmx.matrix_cgsolve(_g("MATRIXF_DATA_CGSOLVE_A", (8, 8)),
                                 load("matrix")["MATRIXF_DATA_CGSOLVE_B"], tol=1e-9)
        np.testing.assert_allclose(got, load("matrix")["MATRIXF_DATA_CGSOLVE_X"], atol=1e-3)
    elif case == "chol":
        got = tmx.matrix_chol(_g("MATRIXF_DATA_CHOL_A", (4, 4)))
        np.testing.assert_allclose(got, _g("MATRIXF_DATA_CHOL_L", (4, 4)), atol=1e-3)
    elif case == "qr":
        A = _g("MATRIXF_DATA_QRDECOMP_A", (4, 4))
        Q, R = tmx.matrix_qrdecomp_gramschmidt(A)
        np.testing.assert_allclose(Q @ R, A, atol=1e-4)
        np.testing.assert_allclose(Q.T @ Q, np.eye(4), atol=1e-5)
        np.testing.assert_allclose(np.abs(Q), np.abs(_g("MATRIXF_DATA_QRDECOMP_Q", (4, 4))),
                                   atol=1e-3)
        np.testing.assert_allclose(np.abs(R), np.abs(_g("MATRIXF_DATA_QRDECOMP_R", (4, 4))),
                                   atol=1e-3)
    elif case == "ludecomp":
        A = _g("MATRIXF_DATA_LUDECOMP_A", (8, 8))
        L, U = tmx.matrix_ludecomp_crout(A)
        np.testing.assert_allclose(L @ U, A, atol=1e-4)
        assert np.allclose(np.diag(U), 1.0)
        L2, U2 = tmx.matrix_ludecomp_doolittle(A)
        np.testing.assert_allclose(L2 @ U2, A, atol=1e-4)
        assert np.allclose(np.diag(L2), 1.0)
    elif case == "transmul":
        got = tmx.matrix_transmul(_g("MATRIXF_DATA_TRANSMUL_X", (5, 4)))
        np.testing.assert_allclose(got, _g("MATRIXF_DATA_TRANSMUL_XTX", (4, 4)), atol=1e-4)
    else:
        Q = tmx.matrix_gramschmidt(_g("MATRIXF_DATA_GRAMSCHMIDT_A", (4, 3)))
        np.testing.assert_allclose(np.abs(Q), np.abs(_g("MATRIXF_DATA_GRAMSCHMIDT_V", (4, 3))),
                                   atol=1e-4)


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _spd(rng, n, dtype):
    a = rng.standard_normal((n, n)).astype(dtype)
    return (a @ a.T + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_dense_matches_yagi_tpu(dtype):
    rng = np.random.default_rng(4)

    def mat(*shape):
        m = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            m = m + 1j * rng.standard_normal(shape)
        return m.astype(dtype)

    a, b, sq, c = mat(5, 4), mat(5, 4), mat(6, 6), mat(4, 3)
    spd = _spd(rng, 6, np.float64).astype(dtype)
    cases = [
        ("matrix_add", (a, b)), ("matrix_sub", (a, b)), ("matrix_mul", (a, c)),
        ("matrix_aug", (a, mat(5, 2))), ("matrix_det", (sq,)),
        ("matrix_trans", (a,)), ("matrix_hermitian", (a,)), ("matrix_transmul", (a,)),
        ("matrix_mul_transpose", (a,)), ("matrix_mul_hermitian", (a,)), ("matrix_inv", (sq,)),
        ("matrix_ludecomp_crout", (sq,)), ("matrix_ludecomp_doolittle", (sq,)),
        ("matrix_qrdecomp_gramschmidt", (mat(6, 4),)), ("matrix_chol", (spd,)),
        ("matrix_linsolve", (sq, mat(6))), ("matrix_gramschmidt", (mat(5, 3),)),
    ]
    if not np.issubdtype(dtype, np.complexfloating):
        cases.append(("matrix_cgsolve", (spd, mat(6))))
    for name, args in cases:
        _same(getattr(tmx, name)(*args), getattr(jmx, name)(*args))


def test_dense_errors():
    a = np.ones((3, 4))
    for fn, args in ((tmx.matrix_add, (a, np.ones((4, 3)))), (tmx.matrix_mul, (a, a)),
                     (tmx.matrix_aug, (a, np.ones((2, 2)))), (tmx.matrix_det, (a,)),
                     (tmx.matrix_inv, (a,)), (tmx.matrix_ludecomp_crout, (a,)),
                     (tmx.matrix_ludecomp_doolittle, (a,)), (tmx.matrix_chol, (a,)),
                     (tmx.matrix_trans, (np.ones(3),))):
        with pytest.raises(ConfigError):
            fn(*args)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_smatrix_matches_yagi_tpu(dtype):
    rng = np.random.default_rng(8)
    d = rng.integers(-3, 4, (6, 5)) * (rng.random((6, 5)) < 0.4)
    if dtype == np.uint8:
        d = np.abs(d) % 2
    d = d.astype(dtype)
    t, j = tmx.SMatrix.from_array(d), jmx.SMatrix.from_array(d)
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    assert t.size() == j.size() and t.dtype == j.dtype
    other = rng.integers(0, 3, (5, 4)).astype(dtype)
    tp, jp = t.mul(tmx.SMatrix.from_array(other)), j.mul(jmx.SMatrix.from_array(other))
    np.testing.assert_array_equal(tp.to_dense(), jp.to_dense())
    x = rng.integers(0, 3, 5).astype(dtype)
    got, want = t.vmul(x), j.vmul(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.vmul_bool(x % 2), j.vmul_bool(x % 2))
    for i, jj, v in ((0, 0, 2), (5, 4, 1), (2, 3, 0)):
        t.set(i, jj, v)
        j.set(i, jj, v)
        assert t.isset(i, jj) == j.isset(i, jj) and t.get(i, jj) == j.get(i, jj)
    t.delete(0, 0)
    j.delete(0, 0)
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    t.eye()
    j.eye()
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    t.reset()
    assert not t.to_dense().any()
    with pytest.raises(ConfigError):
        t.get(6, 0)
    with pytest.raises(ConfigError):
        tmx.SMatrix(0, 3)
    with pytest.raises(ConfigError):
        t.vmul(np.ones(4))
    with pytest.raises(ConfigError):
        t.mul(tmx.SMatrix(4, 4))
