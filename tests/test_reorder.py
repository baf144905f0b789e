import numpy as np
import pytest

from hspmv.bench.matrices import (
    laplacian_2d,
    random_banded,
    random_general,
)
from hspmv.formats.csrk import CSRkMatrix
from hspmv.reorder.coarsen import WeightedGraph, hand_coarsen, matching_coarsen
from hspmv.reorder.compose import uncoarsen_compose
from hspmv.reorder.rcm import bandwidth, rcm


def _is_perm(p, n):
    return p.shape[0] == n and np.array_equal(np.sort(p), np.arange(n))


def test_rcm_is_permutation():
    mat = random_general(400, 6, seed=0)
    perm = rcm(mat.indptr, mat.indices)
    assert _is_perm(perm, 400)


def test_rcm_reduces_bandwidth():
    """RCM on a scrambled banded matrix must recover a small bandwidth."""
    mat = random_banded(500, 12, 6, seed=1)
    rng = np.random.default_rng(0)
    scramble = rng.permutation(500)
    scrambled = mat.permuted(scramble)
    assert bandwidth(scrambled.indptr, scrambled.indices) > 100
    perm = rcm(scrambled.indptr, scrambled.indices)
    fixed = scrambled.permuted(perm)
    assert bandwidth(fixed.indptr, fixed.indices) < 100


def test_rcm_vs_scipy_quality():
    """Our RCM should be within 2x of scipy's RCM bandwidth."""
    sps = pytest.importorskip("scipy.sparse")
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    mat = random_general(1000, 8, seed=2)
    sp = mat.to_scipy()
    sp_perm = reverse_cuthill_mckee(sp, symmetric_mode=True)
    sp_bw = bandwidth(*_perm_csr(mat, np.asarray(sp_perm)))
    ours = rcm(mat.indptr, mat.indices)
    our_bw = bandwidth(*_perm_csr(mat, ours))
    assert our_bw <= max(2 * sp_bw, 64), (our_bw, sp_bw)


def _perm_csr(mat, perm):
    pm = mat.permuted(perm)
    return pm.indptr, pm.indices


def test_rcm_disconnected_components():
    # Two disjoint paths.
    rows = [0, 1, 1, 2, 3, 4, 4, 5]
    cols = [1, 0, 2, 1, 4, 3, 5, 4]
    from hspmv.formats.csr import CSRMatrix

    mat = CSRMatrix.from_coo(rows, cols, np.ones(8, np.float32), (6, 6))
    perm = rcm(mat.indptr, mat.indices)
    assert _is_perm(perm, 6)
    # Components must stay contiguous in the ordering.
    comp = perm < 3
    split = np.flatnonzero(np.diff(comp.astype(int)) != 0)
    assert split.shape[0] == 1


def test_hand_coarsen_budget_rule():
    """Groups close when accumulated nnz reaches the budget before the next
    row (BAND_k::handCoarsen, csrk.cpp:1255-1292)."""
    mat = laplacian_2d(16)
    budget = 8 * mat.nnz // mat.m
    map_ptr, coarse = hand_coarsen(mat.indptr, mat.indices, budget)
    lens = np.diff(mat.indptr)
    # Every group except possibly the last reaches the budget.
    for g in range(map_ptr.shape[0] - 2):
        nnz_g = lens[map_ptr[g] : map_ptr[g + 1]].sum()
        assert nnz_g >= budget
    assert map_ptr[0] == 0 and map_ptr[-1] == mat.m
    assert coarse.n == map_ptr.shape[0] - 1


def test_hand_coarsen_graph_symmetric():
    mat = random_banded(200, 15, 6, seed=3)
    _, coarse = hand_coarsen(mat.indptr, mat.indices, 40)
    dense = np.zeros((coarse.n, coarse.n))
    rows = np.repeat(np.arange(coarse.n), np.diff(coarse.indptr))
    dense[rows, coarse.indices] = coarse.edge_weights
    np.testing.assert_array_equal(dense, dense.T)


def test_matching_coarsen_valid():
    mat = random_general(300, 6, seed=4)
    order, map_ptr, coarse = matching_coarsen(
        mat.indptr, mat.indices, target_size=50, mode="heavy"
    )
    assert _is_perm(order, 300)
    assert map_ptr[-1] == 300
    assert coarse.n == map_ptr.shape[0] - 1
    assert coarse.n <= 300


def test_uncoarsen_compose_identity():
    # One level, identity coarse perm: composition is identity.
    map_ptr = np.array([0, 2, 5, 9])
    perm, (final_map,) = uncoarsen_compose(
        [map_ptr], [np.arange(3)], 9
    )
    np.testing.assert_array_equal(perm, np.arange(9))
    np.testing.assert_array_equal(final_map, map_ptr)


def test_uncoarsen_compose_reorder():
    # Reversing the groups must concatenate ranges in reverse order.
    map_ptr = np.array([0, 2, 5, 9])
    perm, (final_map,) = uncoarsen_compose(
        [map_ptr], [np.array([2, 1, 0])], 9
    )
    np.testing.assert_array_equal(perm, [5, 6, 7, 8, 2, 3, 4, 0, 1])
    np.testing.assert_array_equal(final_map, [0, 4, 7, 9])


@pytest.mark.parametrize("k,sizes", [(2, (8,)), (3, (8, 4)), (4, (8, 4, 4))])
def test_csrk_build_hand(k, sizes):
    mat = random_banded(400, 25, 8, seed=5)
    ck = CSRkMatrix.build(mat, k=k, sup_row_sizes=sizes)
    assert _is_perm(ck.perm, 400)
    assert len(ck.maps) == k - 1
    # Level maps are nested pointer arrays with consistent extents.
    assert ck.maps[0][-1] == 400
    for lvl in range(1, k - 1):
        assert ck.maps[lvl][-1] == ck.maps[lvl - 1].shape[0] - 1
    # SpMV through the permuted matrix matches the serial oracle through
    # the permutation (the reference validation, spmv.cpp:202-209).
    rng = np.random.default_rng(0)
    x = rng.standard_normal(400).astype(np.float32)
    assert ck.validate(ck.spmv_host(x), x, mat, tol=1e-4) == 0


def test_csrk_build_matching():
    mat = random_general(300, 6, seed=6)
    ck = CSRkMatrix.build(mat, k=2, sup_row_sizes=(8,), coarsen_type="heavy")
    assert _is_perm(ck.perm, 300)
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    assert ck.validate(ck.spmv_host(x), x, mat, tol=1e-4) == 0


def test_csrk_k1_is_plain_csr():
    mat = laplacian_2d(8)
    ck = CSRkMatrix.build(mat, k=1)
    np.testing.assert_array_equal(ck.perm, np.arange(64))
    np.testing.assert_array_equal(ck.matrix.indptr, mat.indptr)


def test_csrk_pipeline_reduces_bandwidth():
    """The full data pipeline (fine-level RCM like converter.m:14, then
    CSR-k) must recover a small bandwidth from a scrambled banded matrix,
    and the CSR-k pass must not destroy the band the RCM created."""
    mat = random_banded(600, 10, 6, seed=7)
    scrambled = mat.permuted(np.random.default_rng(3).permutation(600))
    bw0 = bandwidth(scrambled.indptr, scrambled.indices)
    fine_perm = rcm(scrambled.indptr, scrambled.indices)
    rcmd = scrambled.permuted(fine_perm)
    ck = CSRkMatrix.build(rcmd, k=2, sup_row_sizes=(4,))
    bw1 = bandwidth(ck.matrix.indptr, ck.matrix.indices)
    assert bw1 < bw0 / 3, (bw0, bw1)
