import numpy as np
import jax.numpy as jnp

from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
from hspmv.kernels.segsum import SegsumLayout, spmv_segsum


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_segsum_matches_oracle():
    for mat in [laplacian_2d(32), random_banded(1000, 40, 8, seed=1),
                random_general(500, 6, seed=2)]:
        x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
        layout = SegsumLayout.from_csr(mat)
        y = np.asarray(spmv_segsum(layout, jnp.asarray(x)))
        y_ref = mat.matvec(x)
        assert _rel_l2(y, y_ref) < 1e-6, _rel_l2(y, y_ref)


def test_segsum_empty_rows():
    from hspmv.formats.csr import CSRMatrix

    mat = CSRMatrix.from_coo([0, 2], [1, 0], [2.0, 3.0], (3, 2))
    layout = SegsumLayout.from_csr(mat)
    y = np.asarray(spmv_segsum(layout, jnp.array([1.0, 10.0], jnp.float32)))
    np.testing.assert_allclose(y, [20.0, 0.0, 3.0])


def test_spmm_matches_columnwise_spmv():
    import numpy as np
    import jax.numpy as jnp

    from hspmv.bench.matrices import random_banded
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked

    mat = random_banded(256, 24, 6, seed=1)
    lay = RankedSlabs.from_csr(mat)
    B = 3
    X = np.random.default_rng(0).standard_normal((mat.n, B)).astype(np.float32)
    Y = np.asarray(spmv_ranked(lay, jnp.asarray(X)))
    Yref = np.stack([mat.matvec(X[:, b]) for b in range(B)], axis=1)
    assert (
        np.linalg.norm(Y - Yref) / np.linalg.norm(Yref) < 1e-6
    )


def test_spmm_on_binned_layout():
    """SpMM over column-binned slots (scattered matrices): the packed
    window fields are group/bin-consistent with lcols by construction."""
    import jax.numpy as jnp

    from hspmv.bench.matrices import random_general
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked

    mat = random_general(500, 8, seed=4)
    lay = RankedSlabs.from_csr(mat, bin_blocks=4, allow_groups=False)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((mat.n, 4)).astype(np.float32)
    Y = np.asarray(spmv_ranked(lay, jnp.asarray(X)))
    Y_ref = np.stack([mat.matvec(X[:, b]) for b in range(4)], axis=1)
    rel = np.linalg.norm(Y - Y_ref) / np.linalg.norm(Y_ref)
    assert rel < 1e-6, rel



def test_validate_magnitude_aware_tolerance():
    """validate() counts |delta| > tol * max(1, |oracle|): reference
    semantics (abs 0.01, spmv-csrk/spmv.cpp:202-211) for O(1) entries,
    relative beyond — fp32 rounding on large-magnitude y (the r4 fem_1m
    cotangent-stiffness row) must not read as wrong."""
    from hspmv.bench.harness import validate

    oracle = np.array([0.5, -0.25, 2.0e6, -3.0e6], np.float64)
    # O(1) entries: abs semantics (0.02 > 0.01 is wrong, 0.005 is not).
    y = oracle + np.array([0.02, 0.005, 0.0, 0.0])
    wrong, _ = validate(y, oracle)
    assert wrong == 1
    # Large entries: fp32-scale relative noise passes, 2% relative fails.
    y = oracle + np.array([0.0, 0.0, 0.5, -6.0e4])
    wrong, _ = validate(y, oracle)
    assert wrong == 1  # only the 2% error on -3e6


def test_dense_baseline_matches_oracle_and_caps():
    import pytest

    from hspmv.kernels.dense import DenseLayout, spmv_dense

    for mat in [laplacian_2d(24), random_general(500, 6, seed=3)]:
        x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
        lay = DenseLayout.from_csr(mat)
        y = np.asarray(spmv_dense(lay, jnp.asarray(x)))
        assert _rel_l2(y, mat.matvec(x)) < 1e-6
    # rectangular: m != n
    from hspmv.formats.csr import CSRMatrix

    rect = CSRMatrix.from_coo([0, 2], [1, 0], [2.0, 3.0], (3, 2))
    yr = np.asarray(spmv_dense(DenseLayout.from_csr(rect),
                               jnp.array([1.0, 10.0], jnp.float32)))
    np.testing.assert_allclose(yr, [20.0, 0.0, 3.0])
    # the size cap refuses large densifications
    with pytest.raises(ValueError):
        DenseLayout.from_csr(laplacian_2d(24), max_elems=1000)
