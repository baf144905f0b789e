import numpy as np
import pytest

from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
from hspmv.formats.csr import CSRMatrix


def test_from_coo_dedup():
    rows = [0, 0, 1, 1, 1]
    cols = [0, 0, 1, 2, 2]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    mat = CSRMatrix.from_coo(rows, cols, vals, (2, 3))
    dense = mat.to_dense()
    assert dense[0, 0] == 3.0
    assert dense[1, 1] == 3.0
    assert dense[1, 2] == 9.0
    assert mat.nnz == 3


def test_matvec_matches_dense():
    mat = random_general(200, 6, seed=3)
    x = np.random.default_rng(0).standard_normal(200).astype(np.float32)
    y = mat.matvec(x)
    y_ref = mat.to_dense() @ x
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)


def test_matvec_empty_rows():
    mat = CSRMatrix.from_coo([0, 2], [1, 0], [2.0, 3.0], (3, 2))
    y = mat.matvec(np.array([1.0, 10.0], np.float32))
    np.testing.assert_allclose(y, [20.0, 0.0, 3.0])


def test_matvec_trailing_empty_rows():
    """ADVICE r1 repro: indptr [0,2,5,5] must give y[1] = full 3-term sum
    (reduceat-with-clipped-starts truncated it to the last 2 terms)."""
    mat = CSRMatrix(
        np.array([0, 2, 5, 5], np.int32),
        np.array([0, 1, 0, 1, 2], np.int32),
        np.array([1.0, 1.0, 1.0, 10.0, 100.0], np.float32),
        (3, 3),
    )
    y = mat.matvec(np.array([1.0, 1.0, 1.0], np.float32))
    np.testing.assert_allclose(y, [2.0, 111.0, 0.0])


def test_permuted_round_trip():
    mat = random_banded(300, 20, 8, seed=4)
    rng = np.random.default_rng(1)
    perm = rng.permutation(300)
    pm = mat.permuted(perm)
    # Dense check: pm == A[perm][:, perm]
    dense = mat.to_dense()
    np.testing.assert_allclose(pm.to_dense(), dense[np.ix_(perm, perm)])
    # Columns sorted ascending per row
    for i in range(pm.m):
        cols = pm.indices[pm.indptr[i] : pm.indptr[i + 1]]
        assert (np.diff(cols) > 0).all()


def test_permuted_spmv_equivalence():
    """y_perm[i] == y[perm[i]] — the reference's validation identity
    (spmv-csrk/spmv.cpp:202-209)."""
    mat = random_banded(500, 30, 10, seed=5)
    rng = np.random.default_rng(2)
    perm = rng.permutation(500)
    x = rng.standard_normal(500).astype(np.float32)
    pm = mat.permuted(perm)
    y_perm = pm.matvec(x[perm])
    y = mat.matvec(x)
    np.testing.assert_allclose(y_perm, y[perm], rtol=1e-4, atol=1e-4)


def test_stats_keys():
    mat = laplacian_2d(16)
    s = mat.stats()
    assert s["total_nnz"] == mat.nnz
    assert s["nnz_max"] == 5
    assert s["nnz_min"] == 3
    assert s["band_max"] == 32  # row-major 2D stencil band = 2*nx


@pytest.mark.parametrize("m,n", [(5, 7), (1, 1)])
def test_shape_validation(m, n):
    with pytest.raises(ValueError):
        CSRMatrix(np.zeros(m, np.int32), np.zeros(0, np.int32),
                  np.zeros(0, np.float32), (m, n))


def test_layout_save_load_roundtrip(tmp_path):
    import numpy as np

    from hspmv.bench.matrices import random_banded
    from hspmv.formats.sell import RankedSlabs, SellSlabs, load_layout

    mat = random_banded(400, 30, 6, seed=1)
    for Cls in (SellSlabs, RankedSlabs):
        lay = Cls.from_csr(mat)
        p = tmp_path / f"{Cls.__name__}.npz"
        lay.save(p)
        lay2 = load_layout(p)
        assert type(lay2) is Cls
        c1, a1 = lay.tree_flatten()
        c2, a2 = lay2.tree_flatten()
        assert a1 == a2
        for x, y in zip(c1, c2):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_layout_cache_rejects_wrong_matrix(tmp_path):
    from hspmv.bench.matrices import random_banded
    from hspmv.formats.sell import SellSlabs, load_layout

    mat = random_banded(400, 30, 6, seed=1)
    other = random_banded(400, 30, 6, seed=2)
    lay = SellSlabs.from_csr(mat)
    p = tmp_path / "lay.npz"
    lay.save(p, matrix=mat)
    assert type(load_layout(p, matrix=mat)) is SellSlabs
    with pytest.raises(ValueError, match="different matrix"):
        load_layout(p, matrix=other)


def test_sigma_sort_reduces_padding():
    import numpy as np

    from hspmv.bench.matrices import random_general
    from hspmv.formats.sell import SellSlabs, sigma_sort

    # Skewed degrees: power-law-ish lengths via overlaying several
    # random matrices.
    from hspmv.formats.csr import CSRMatrix

    rng = np.random.default_rng(0)
    m = 4096
    rows = np.concatenate([
        rng.integers(0, m, 6 * m),
        rng.integers(0, m // 50, 30 * m // 50),  # heavy rows at the top
    ])
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    mat = CSRMatrix.from_coo(rows, cols, vals, (m, m))

    plain = SellSlabs.from_csr(mat)
    sorted_mat, perm = sigma_sort(mat)
    assert np.array_equal(np.sort(perm), np.arange(m))
    srt = SellSlabs.from_csr(sorted_mat)
    assert srt.padding_ratio < plain.padding_ratio * 0.8

    # Row-permutation semantics: y_sorted[i] == y_orig[perm[i]].
    x = rng.standard_normal(m).astype(np.float32)
    np.testing.assert_allclose(
        sorted_mat.matvec(x), mat.matvec(x)[perm], rtol=1e-6
    )


def test_csr_diagonal():
    import numpy as np

    from hspmv.formats.csr import CSRMatrix

    m = CSRMatrix(
        np.array([0, 2, 3, 3]), np.array([0, 2, 1]),
        np.array([5.0, 7.0, 9.0], dtype=np.float32), (3, 3),
    )
    assert np.array_equal(m.diagonal(), [5.0, 9.0, 0.0])


def test_ranked_explicit_zero_entries():
    """Stored zeros are structural: the r3 O(nnz) window derivation
    includes them in gather windows (conservative — the old padded-array
    scan treated val==0.0 slots as padding), and their lcol is forced
    inert. Either way y must match the oracle exactly."""
    import numpy as np
    import jax.numpy as jnp

    from hspmv.formats.csr import CSRMatrix
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked

    rng = np.random.default_rng(0)
    m = 300
    indptr = np.arange(0, 4 * m + 1, 4, dtype=np.int64)
    indices = np.sort(
        rng.integers(0, m, size=(m, 4)), axis=1
    ).astype(np.int32).reshape(-1)
    data = rng.standard_normal(4 * m).astype(np.float32)
    data[::7] = 0.0  # explicit stored zeros
    mat = CSRMatrix(indptr, indices, data, (m, m))
    lay = RankedSlabs.from_csr(mat, bin_blocks=2)
    x = rng.standard_normal(m).astype(np.float32)
    y = np.asarray(spmv_ranked(lay, jnp.asarray(x)))
    ref = mat.matvec(x)
    rel = np.linalg.norm(y - ref) / max(np.linalg.norm(ref), 1e-30)
    assert rel < 1e-6, rel


def test_variable_stencil_structure():
    """Varying-coefficient 5-point stencil (thermal2 class): symmetric,
    SPD, exactly 5 diagonals in natural order, values NOT constant per
    diagonal (distinguishes the DIA path's constant-friendly cases)."""
    import numpy as np

    from hspmv.bench.matrices import variable_stencil
    from hspmv.formats.dia import diagonal_profile

    mat = variable_stencil(48, seed=4)
    d, fill = diagonal_profile(mat)
    assert d == 5 and fill < 1.1
    sp = mat.to_scipy()
    assert (abs(sp - sp.T) > 0).nnz == 0  # symmetric
    # off-diagonal values vary (not a constant stencil)
    off = mat.data[mat.indices != np.repeat(
        np.arange(mat.m), mat.row_lengths
    )]
    assert np.unique(off).size > 100


def test_ranked_tile_padup_correctness():
    """The slab stack holds exactly the chunks' 8-slot sub-tiles: no
    padding sub-tiles past the last chunk, and the oracle result."""
    import jax.numpy as jnp

    from hspmv.bench.matrices import random_banded
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked
    from hspmv.reorder import rcm

    mat = random_banded(40_000, 400, 9, seed=7)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    lay = RankedSlabs.from_csr(mat, bin_blocks=2)
    sub_chunk = np.asarray(lay.sub_chunk)
    assert np.all(sub_chunk < lay.num_chunks)
    assert int(lay.vals.shape[0]) == 8 * sub_chunk.size
    x = np.random.default_rng(3).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_ranked(lay, jnp.asarray(x)))
    y_ref = mat.matvec(x)
    assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) < 1e-6
