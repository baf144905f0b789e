import numpy as np
import jax.numpy as jnp
import pytest

from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
from hspmv.formats.csr import CSRMatrix
from hspmv.formats.sell import SellSlabs, LANES, SUBLANES
from hspmv.kernels.sell import spmv_sell, spmv_sell_reference


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize(
    "mat",
    [
        laplacian_2d(16),
        random_banded(400, 30, 6, seed=1),
        random_general(300, 5, seed=2),
    ],
    ids=["lap2d", "banded", "general"],
)
def test_sell_matches_oracle(mat):
    lay = SellSlabs.from_csr(mat)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y_ref = mat.matvec(x)
    assert _rel(spmv_sell_reference(lay, x), y_ref) < 1e-6
    y = np.asarray(spmv_sell(lay, jnp.asarray(x)))
    assert _rel(y, y_ref) < 1e-6


def test_sell_layout_invariants():
    mat = random_banded(2000, 60, 10, seed=3)
    lay = SellSlabs.from_csr(mat)
    assert lay.vals.shape == lay.cols.shape
    assert int(lay.vals.shape[0]) % SUBLANES == 0
    # Total stored values match nnz (padding is zeros).
    assert np.count_nonzero(np.asarray(lay.vals)) <= mat.nnz
    assert float(np.abs(np.asarray(lay.vals)).sum()) == pytest.approx(
        float(np.abs(mat.data).sum()), rel=1e-6
    )
    # Every column id within the sub-tile's declared block range.
    cols = np.asarray(lay.cols).reshape(-1, SUBLANES * LANES)
    blk = cols >> 7
    b0 = np.asarray(lay.sub_b0)[:, None]
    nb = np.asarray(lay.sub_nb)[:, None]
    assert (blk >= b0).all() and (blk < b0 + nb).all()


def test_sell_empty_rows_and_ragged_m():
    # m not a multiple of 128, including fully empty rows.
    rows = [0, 5, 130, 130, 200]
    cols = [3, 1, 0, 99, 150]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    mat = CSRMatrix.from_coo(rows, cols, vals, (201, 151))
    lay = SellSlabs.from_csr(mat)
    x = np.arange(151, dtype=np.float32)
    y = spmv_sell_reference(lay, x)
    np.testing.assert_allclose(y, mat.matvec(x), rtol=1e-5)
    y2 = np.asarray(spmv_sell(lay, jnp.asarray(x)))
    np.testing.assert_allclose(y2, mat.matvec(x), rtol=1e-5)


def test_sell_single_chunk():
    mat = random_banded(64, 10, 4, seed=4)
    lay = SellSlabs.from_csr(mat)
    x = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    y = np.asarray(spmv_sell(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6



def test_ranked_matches_oracle():
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked

    # Small sizes: interpret mode executes eagerly per sub-tile.
    for mat in (laplacian_2d(16), random_banded(192, 24, 6, seed=1),
                random_general(140, 5, seed=2)):
        lay = RankedSlabs.from_csr(mat)
        x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
        y = np.asarray(spmv_ranked(lay, jnp.asarray(x)))
        assert _rel(y, mat.matvec(x)) < 1e-6


def _binned_parity(mats, widths):
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked

    for mat in mats:
        x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
        y_ref = mat.matvec(x)
        for w in widths:
            lay = RankedSlabs.from_csr(mat, bin_blocks=w)
            assert lay.rank_nb <= w
            y = np.asarray(spmv_ranked(lay, jnp.asarray(x)))
            assert _rel(y, y_ref) < 1e-6, (w, mat.shape)


def test_binned_matches_oracle():
    """Column-binned slots (scattered-matrix mode): small default
    variant covering scattered structure at a narrow and a wide bin."""
    _binned_parity([random_general(600, 8, seed=2)], (1, 4))


@pytest.mark.slow
def test_binned_matches_oracle_full():
    """Full parity matrix: every bin width on scattered, banded, and
    stencil structure (HSPMV_FULL_TESTS=1)."""
    _binned_parity(
        (random_general(2000, 8, seed=2),
         random_banded(1500, 300, 8, seed=1),
         laplacian_2d(40)),
        (1, 2, 4, 8),
    )


def test_binned_wide_fori_path():
    """Wide bins trigger the fori sub-tile loop (_UNROLL_BUDGET); parity
    must hold there too (the scattered asymptote runs at W=32/64)."""
    _binned_parity([random_general(700, 10, seed=4)], (32,))


def test_binned_slots_invariants():
    """Every slot's columns stay inside one bin; entry count preserved."""
    from hspmv.formats.sell import _binned_slots

    mat = random_general(3000, 10, seed=7)
    for w in (1, 4):
        slots, kc = _binned_slots(mat, w)
        assert slots.shape[0] == mat.nnz
        rows = np.repeat(np.arange(mat.m), mat.row_lengths)
        chunks = rows // LANES
        # No slot collisions within (chunk, slot, lane).
        lane = rows % LANES
        key = (chunks * (kc.max() + 1) + slots) * LANES + lane
        assert np.unique(key).shape[0] == mat.nnz
        # Per-(chunk, slot) column span <= bin width.
        blocks = mat.indices.astype(np.int64) >> 7
        k2 = chunks * (kc.max() + 1) + slots
        import collections
        lo = {}
        hi = {}
        for kk, bb in zip(k2, blocks):
            lo[kk] = min(lo.get(kk, bb), bb)
            hi[kk] = max(hi.get(kk, bb), bb)
        span = max(h - lo[k] for k, h in hi.items())
        assert span < w + 1
