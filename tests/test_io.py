import numpy as np

from hspmv.bench.matrices import random_banded
from hspmv.formats.csr import CSRMatrix
from hspmv.io.csr_text import (
    read_csr3_text,
    read_csr_text,
    write_csr3_text,
    write_csr_text,
)
from hspmv.io.matrix_market import read_mtx, write_mtx


def _assert_same(a: CSRMatrix, b: CSRMatrix):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    # Text formats store 6 decimals ("%.6f", like the reference writers).
    np.testing.assert_allclose(a.data, b.data, atol=1e-6)


def test_csr_text_round_trip(tmp_path):
    mat = random_banded(100, 10, 6, seed=0)
    p = tmp_path / "a.csr"
    write_csr_text(p, mat)
    _assert_same(read_csr_text(p), mat)


def test_csr_text_one_based(tmp_path):
    """CSR-k drivers read 1-based files (spmv-csrk/spmv.cpp:57-67);
    autodetect must normalize both bases to the same matrix."""
    mat = random_banded(50, 8, 4, seed=1)
    p0, p1 = tmp_path / "z.csr", tmp_path / "o.csr"
    write_csr_text(p0, mat, base=0)
    write_csr_text(p1, mat, base=1)
    _assert_same(read_csr_text(p0), read_csr_text(p1))


def test_mtx_round_trip(tmp_path):
    mat = random_banded(60, 12, 6, seed=2)
    p = tmp_path / "a.mtx"
    write_mtx(p, mat, comment=" test matrix")
    _assert_same(read_mtx(p), mat)


def test_mtx_symmetric(tmp_path):
    p = tmp_path / "s.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 4\n"
        "1 1 2.0\n"
        "2 1 -1.0\n"
        "2 2 2.0\n"
        "3 3 1.0\n"
    )
    mat = read_mtx(p)
    dense = mat.to_dense()
    np.testing.assert_allclose(
        dense, [[2, -1, 0], [-1, 2, 0], [0, 0, 1]], rtol=1e-6
    )


def test_mtx_pattern(tmp_path):
    p = tmp_path / "p.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 2 2\n"
        "1 2\n"
        "2 1\n"
    )
    mat = read_mtx(p)
    np.testing.assert_allclose(mat.to_dense(), [[0, 1], [1, 0]])


def test_csr3_round_trip(tmp_path):
    mat = random_banded(80, 10, 5, seed=3)
    coarsest = np.array([0, 3, 7, 10], np.int64)
    coarser = np.array([0, 10, 20, 30, 45, 60, 65, 70, 74, 78, 80], np.int64)
    p = tmp_path / "a.csr3"
    write_csr3_text(p, mat, coarsest, coarser)
    mat2, c1, c2 = read_csr3_text(p)
    _assert_same(mat2, mat)
    np.testing.assert_array_equal(c1, coarsest)
    np.testing.assert_array_equal(c2, coarser)


def test_csr2_roundtrip(tmp_path):
    import numpy as np

    from hspmv.bench.matrices import random_banded
    from hspmv.formats.csrk import CSRkMatrix
    from hspmv.io.csr_text import read_csr2_text, write_csr2_text

    mat = random_banded(500, 30, 8, seed=0)
    ck = CSRkMatrix.build(mat, k=2, sup_row_sizes=(16,))
    p = tmp_path / "t.csr2"
    write_csr2_text(p, ck.matrix, ck.maps[0])
    back, sup = read_csr2_text(p)
    np.testing.assert_array_equal(back.indptr, ck.matrix.indptr)
    np.testing.assert_array_equal(back.indices, ck.matrix.indices)
    # %.6f text: absolute error bounded by 5e-7.
    np.testing.assert_allclose(back.data, ck.matrix.data, atol=1e-6)
    np.testing.assert_array_equal(sup, np.asarray(ck.maps[0], dtype=np.int32))
