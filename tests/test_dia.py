"""DIA (diagonal-offset) layout + plain-XLA SpMV for stencil matrices."""

import numpy as np
import jax.numpy as jnp
import pytest

from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
from hspmv.formats.csr import CSRMatrix
from hspmv.formats.dia import DiaSlabs, diagonal_profile
from hspmv.kernels.dia import spmv_dia, spmv_dia_reference


def _rel(y, y_ref):
    return np.linalg.norm(y - y_ref) / max(np.linalg.norm(y_ref), 1e-30)


def test_diagonal_profile():
    mat = laplacian_2d(32)  # 5-point stencil: offsets 0, +-1, +-32
    d, fill = diagonal_profile(mat)
    assert d == 5
    assert fill == pytest.approx(5 * mat.m / mat.nnz)
    # Sampled probe agrees on a pure stencil.
    d_s, _ = diagonal_profile(mat, sample_rows=64)
    assert d_s == 5
    # Scattered matrix: ~one diagonal per nonzero -> rejected by fill.
    d_g, fill_g = diagonal_profile(random_general(512, 6, seed=0))
    assert fill_g > 10
    # Non-square is never DIA.
    sub = CSRMatrix(
        np.array([0, 1], np.int32), np.array([3], np.int32),
        np.ones(1, np.float32), (1, 8),
    )
    assert diagonal_profile(sub)[1] == float("inf")


def test_dia_matches_oracle_stencil():
    """5-point Laplacian: the flagship DIA shape (offsets 0, +-1,
    +-grid)."""
    mat = laplacian_2d(40)  # m=1600, offsets 0,+-1,+-40
    lay = DiaSlabs.from_csr(mat)
    assert lay.num_diagonals == 5
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_dia(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6
    # The layout-level oracle agrees too (kernel vs layout separation).
    assert _rel(spmv_dia_reference(lay, x), mat.matvec(x)) < 1e-6


def test_dia_matches_oracle_aligned_offsets():
    """Grid 128: offsets that are whole multiples of 128."""
    mat = laplacian_2d(128)
    lay = DiaSlabs.from_csr(mat)
    x = np.random.default_rng(1).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_dia(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


def test_dia_partial_diagonals():
    """Diagonals with holes (banded random keeps offsets but drops
    entries) still reproduce exactly: absent entries stay 0.0."""
    mat = random_banded(1000, 12, 6, seed=3)
    d, fill = diagonal_profile(mat)
    lay = DiaSlabs.from_csr(mat, max_diags=40, max_fill=8.0)
    assert lay.num_diagonals == d
    x = np.random.default_rng(2).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_dia(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


@pytest.mark.parametrize("shape", [
    ("lap2d", 24), ("lap2d", 33), ("lap3d", 9), ("band", 3), ("band", 17),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dia_plain_matches_layout_reference(shape, dtype):
    """The plain-XLA DIA product against the layout-level NumPy oracle
    (spmv_dia_reference) and the CSR oracle of the operator it stores:
    first/last rows (diagonals leaving the matrix) included."""
    from hspmv.bench.matrices import laplacian_3d

    kind, size = shape
    if kind == "lap2d":
        mat = laplacian_2d(size)
    elif kind == "lap3d":
        mat = laplacian_3d(size)
    else:
        mat = random_banded(900, size, 6, seed=size)
    vdt = jnp.bfloat16 if dtype == "bf16" else None
    lay = DiaSlabs.from_csr(mat, max_diags=64, max_fill=16.0, val_dtype=vdt)
    x = np.random.default_rng(size).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_dia(lay, jnp.asarray(x)))
    assert y.shape == (mat.m,)
    assert _rel(y, spmv_dia_reference(lay, x)) < 1e-6
    oracle = mat if vdt is None else mat.rounded(vdt)
    assert _rel(y, oracle.matvec(x)) < 1e-6


def test_dia_rejects_non_stencil():
    with pytest.raises(ValueError, match="diagonals|fill"):
        DiaSlabs.from_csr(random_general(512, 6, seed=1))
    sub = CSRMatrix(
        np.array([0, 1], np.int32), np.array([3], np.int32),
        np.ones(1, np.float32), (1, 8),
    )
    with pytest.raises(ValueError, match="square"):
        DiaSlabs.from_csr(sub)


def test_dia_rejects_empty_matrix():
    """Zero-nnz input passes the d/fill admission gates but the kernels
    cannot form guard windows over an empty offsets tuple (review r5):
    from_csr must reject it like any not-diagonal-structured matrix."""
    import pytest

    from hspmv.formats.csr import CSRMatrix
    from hspmv.formats.dia import DiaSlabs

    empty = CSRMatrix.from_coo([], [], [], (256, 256))
    with pytest.raises(ValueError):
        DiaSlabs.from_csr(empty)
