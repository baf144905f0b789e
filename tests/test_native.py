"""Native C++ core vs NumPy reference: exact-equality parity tests."""

import numpy as np
import pytest

from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
from hspmv.formats.csr import CSRMatrix
from hspmv.reorder import native
from hspmv.reorder.coarsen import hand_coarsen as np_hand_coarsen
from hspmv.reorder.rcm import rcm as np_rcm

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native core unavailable: {native.load_error()}"
)


@pytest.mark.parametrize(
    "mat",
    [
        laplacian_2d(20),
        random_banded(800, 30, 8, seed=1),
        random_general(500, 6, seed=2),
    ],
    ids=["lap2d", "banded", "general"],
)
def test_rcm_exact_parity(mat):
    ours = native.rcm(mat.indptr, mat.indices)
    ref = np_rcm(mat.indptr, mat.indices)
    np.testing.assert_array_equal(ours, ref)


def test_rcm_weighted_parity():
    mat = random_general(400, 8, seed=3)
    w = (np.arange(mat.nnz) % 5 + 1).astype(np.int64)
    ours = native.rcm(mat.indptr, mat.indices, w)
    ref = np_rcm(mat.indptr, mat.indices, w)
    np.testing.assert_array_equal(ours, ref)


def test_rcm_disconnected_parity():
    rows = [0, 1, 1, 2, 3, 4, 4, 5, 7, 8]
    cols = [1, 0, 2, 1, 4, 3, 5, 4, 8, 7]
    mat = CSRMatrix.from_coo(rows, cols, np.ones(10, np.float32), (9, 9))
    np.testing.assert_array_equal(
        native.rcm(mat.indptr, mat.indices), np_rcm(mat.indptr, mat.indices)
    )


def test_hand_coarsen_boundaries_parity():
    mat = random_banded(1000, 40, 10, seed=4)
    budget = 8 * mat.nnz // mat.m
    ref_map, _ = np_hand_coarsen(mat.indptr, mat.indices, budget)
    ours = native.hand_coarsen_boundaries(mat.indptr, budget)
    np.testing.assert_array_equal(ours, ref_map)


def test_permute_symmetric_parity():
    mat = random_banded(600, 25, 8, seed=5)
    perm = np.random.default_rng(0).permutation(600)
    indptr, indices, data = native.permute_symmetric(
        mat.indptr, mat.indices, mat.data, perm
    )
    dense = mat.to_dense()
    out = CSRMatrix(indptr, indices, data, mat.shape)
    np.testing.assert_allclose(out.to_dense(), dense[np.ix_(perm, perm)])
    for i in range(out.m):
        cols = out.indices[out.indptr[i] : out.indptr[i + 1]]
        assert (np.diff(cols) > 0).all()


def test_sell_targets_parity():
    mat = random_banded(500, 20, 6, seed=6)
    lanes = 128
    num_chunks = -(-500 // lanes)
    lens = np.zeros(num_chunks * lanes, dtype=np.int64)
    lens[:500] = mat.row_lengths
    kc = np.maximum((lens.reshape(num_chunks, lanes).max(axis=1) + 7) // 8 * 8, 8)
    koff = np.zeros(num_chunks + 1, dtype=np.int64)
    np.cumsum(kc, out=koff[1:])
    dest_k, dest_l = native.sell_targets(mat.indptr, koff, lanes)
    rows = np.repeat(np.arange(500, dtype=np.int64), mat.row_lengths)
    ranks = np.arange(mat.nnz) - np.repeat(mat.indptr[:-1].astype(np.int64), mat.row_lengths)
    np.testing.assert_array_equal(dest_k, koff[rows // lanes] + ranks)
    np.testing.assert_array_equal(dest_l, rows % lanes)


def test_greedy_color_parity_and_validity():
    if not native.available():
        import pytest

        pytest.skip("native core unavailable")
    mat = random_banded(800, 30, 8, seed=7)
    color = native.greedy_color(mat.indptr, mat.indices)
    rows = np.repeat(np.arange(mat.m), mat.row_lengths)
    cols = mat.indices.astype(np.int64)
    off = rows != cols
    assert (color[rows[off]] != color[cols[off]]).all()
    # Exact parity with the pure-Python first-fit reference.
    from hspmv.sts import host as sts_host

    mark = np.full(mat.m + 1, -1, dtype=np.int64)
    ref = np.full(mat.m, -1, dtype=np.int64)
    indptr = mat.indptr.astype(np.int64)
    indices = mat.indices.astype(np.int64)
    for v in range(mat.m):
        nbrs = indices[indptr[v] : indptr[v + 1]]
        ncols = ref[nbrs]
        mark[ncols[ncols >= 0]] = v
        c = 0
        while mark[c] == v:
            c += 1
        ref[v] = c
    np.testing.assert_array_equal(color, ref)


def test_level_schedule_parity():
    if not native.available():
        import pytest

        pytest.skip("native core unavailable")
    mat = random_banded(800, 30, 8, seed=8)
    lev = native.level_schedule(mat.indptr, mat.indices)
    rows = np.repeat(np.arange(mat.m), mat.row_lengths)
    cols = mat.indices.astype(np.int64)
    strict = cols < rows
    assert (lev[cols[strict]] < lev[rows[strict]]).all()
    # Rows without strict-lower entries are level 0.
    has_dep = np.zeros(mat.m, dtype=bool)
    has_dep[rows[strict]] = True
    assert (lev[~has_dep] == 0).all()


def test_aligned_slots_parity(monkeypatch):
    """Native aligned-slots must match the NumPy implementation exactly
    (it is the layout-build hot loop; VERDICT r1 #6)."""
    import hspmv.formats.sell as sellmod
    from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
    from hspmv.reorder import native

    if not native.available():
        pytest.skip(f"native core unavailable: {native.load_error()}")
    for mat in (laplacian_2d(48), random_banded(3000, 80, 9, seed=2),
                random_general(1500, 6, seed=3)):
        slots_c, kc_c = native.aligned_slots(mat.indptr, mat.indices)
        with monkeypatch.context() as mp:
            mp.setattr(native, "available", lambda: False)
            slots_py, kc_py = sellmod._aligned_slots(mat)
        np.testing.assert_array_equal(kc_c, kc_py)
        np.testing.assert_array_equal(slots_c, slots_py)


def test_binned_slots_parity(monkeypatch):
    """Native column-binned slots (incl. the packed-delta repair) must
    match the NumPy implementation exactly (VERDICT r2 #7: the Python
    per-entry repair loop crawled on adversarial scattered chunks)."""
    import hspmv.formats.sell as sellmod
    from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
    from hspmv.reorder import native

    if not native.available():
        pytest.skip(f"native core unavailable: {native.load_error()}")
    # Adversarial: sparse rows with far-scattered columns pack distant
    # bins into one 8-slot group -> every chunk is a repair suspect (the
    # STS scattered-dependency shape).
    rng = np.random.default_rng(9)
    m_adv, n_adv, k_adv = 1024, 2_000_000, 3
    cols = np.sort(
        rng.integers(0, n_adv, (m_adv, k_adv), dtype=np.int64), axis=1
    )
    indptr = np.arange(m_adv + 1, dtype=np.int64) * k_adv
    adversarial = CSRMatrix(
        indptr.astype(np.int32) if indptr[-1] < 2**31 else indptr,
        cols.reshape(-1).astype(np.int32),
        np.ones(m_adv * k_adv, np.float32),
        (m_adv, n_adv),
    )
    mats = [
        laplacian_2d(40),
        random_banded(1500, 300, 8, seed=1),
        random_general(2000, 8, seed=2),
        adversarial,
    ]
    for mat in mats:
        for w in (1, 4, 16):
            slots_c, kc_c = native.binned_slots(mat.indptr, mat.indices, w)
            with monkeypatch.context() as mp:
                mp.setattr(native, "available", lambda: False)
                slots_py, kc_py = sellmod._binned_slots(mat, w)
            np.testing.assert_array_equal(kc_c, kc_py, err_msg=f"W={w}")
            np.testing.assert_array_equal(slots_c, slots_py, err_msg=f"W={w}")


def test_binned_slots_scales():
    """1M-row scattered matrix with (near-)all chunks suspect builds in
    seconds on the native path (VERDICT r2 #7 done-criterion)."""
    import time

    from hspmv.bench.matrices import random_general
    from hspmv.reorder import native

    if not native.available():
        pytest.skip(f"native core unavailable: {native.load_error()}")
    mat = random_general(1_000_000, 6, seed=3)
    t0 = time.perf_counter()
    slots, kc = native.binned_slots(mat.indptr, mat.indices, 4)
    dt = time.perf_counter() - t0
    assert slots.shape[0] == mat.nnz
    assert kc.shape[0] == -(-mat.m // 128)
    assert dt < 2.0, f"native binned slots took {dt:.2f}s"


def test_maximal_matching_parity(monkeypatch):
    """Native matching must be bit-identical to the NumPy loop for every
    mode (VERDICT r1 missing #5: the Python loop was scale-unusable)."""
    import hspmv.reorder.coarsen as cz
    from hspmv.bench.matrices import random_general
    from hspmv.reorder import native

    if not native.available():
        pytest.skip(f"native core unavailable: {native.load_error()}")
    mat = random_general(2000, 6, seed=5)
    g = cz.WeightedGraph.from_csr(mat.indptr, mat.indices)
    g.edge_weights = (np.arange(g.nnz, dtype=np.int64) % 7) + 1
    for mode in ("random", "heavy", "light"):
        rng1 = np.random.default_rng(3)
        m_native = cz._maximal_matching(g, mode, rng1)
        with monkeypatch.context() as mp:
            mp.setattr(native, "available", lambda: False)
            rng2 = np.random.default_rng(3)
            m_py = cz._maximal_matching(g, mode, rng2)
        np.testing.assert_array_equal(m_native, m_py)


def test_matching_coarsen_scales():
    """Native path makes matching coarsening usable at 200k vertices."""
    import time

    from hspmv.bench.matrices import laplacian_2d
    from hspmv.reorder import native
    from hspmv.reorder.coarsen import matching_coarsen

    if not native.available():
        pytest.skip(f"native core unavailable: {native.load_error()}")
    mat = laplacian_2d(448)  # ~200k rows
    t0 = time.perf_counter()
    order, map_ptr, coarse = matching_coarsen(
        mat.indptr, mat.indices, target_size=mat.m // 16, mode="heavy"
    )
    dt = time.perf_counter() - t0
    assert coarse.n <= mat.m // 16 * 2 + 1
    assert map_ptr[-1] == mat.m
    assert np.array_equal(np.sort(order), np.arange(mat.m))
    assert dt < 30.0, f"matching coarsen took {dt:.1f}s"
