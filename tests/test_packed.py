"""Packed mixed-height layout + kernel (formats/packed.py).

The sublane-quantum padding (8/avg_row_len, 1.60x on the flagship
class) is removed by stacking chunk slabs back-to-back; correctness
rides the in-kernel 3-way segmented reduce and the cross-tile carry.
"""

import numpy as np
import jax.numpy as jnp

from hspmv.bench.matrices import laplacian_2d, random_banded
from hspmv.formats.packed import PackedRanked
from hspmv.kernels.packed import spmv_packed


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_packed_matches_oracle():
    for mat in (
        laplacian_2d(16),
        laplacian_2d(40),
        random_banded(640, 40, 8, seed=4),
        random_banded(500, 60, 5, seed=1),  # skewed heights
    ):
        lay = PackedRanked.from_csr(mat)
        x = np.random.default_rng(0).standard_normal(mat.n).astype(
            np.float32
        )
        y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
        assert _rel(y, mat.matvec(x)) < 1e-6, mat.shape


def test_packed_carry_crosses_tiles():
    """Chunks straddling 8-slot sub-tile boundaries reduce into one
    total each (~22.5k rows, 176 chunks of 5 slot rows)."""
    mat = laplacian_2d(150)
    lay = PackedRanked.from_csr(mat)
    from hspmv.kernels.slab import packed_slot_chunks

    sc = np.asarray(packed_slot_chunks(lay))
    sub = np.arange(sc.size) // 8
    first = np.full(lay.num_chunks + 1, sc.size)
    last = np.zeros(lay.num_chunks + 1, np.int64)
    np.minimum.at(first, sc, sub)
    np.maximum.at(last, sc, sub)
    straddle = (last > first)[: lay.num_chunks]
    assert straddle.sum() > 50  # about half the chunks cross one
    x = np.random.default_rng(1).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


def test_packed_removes_quantum_padding():
    """On the flagship class (RCM-banded, ~5 nnz/row) the packed layout
    must hold padding near 1.0x where the quantized layout pays ~1.6x
    (VERDICT r2 weak #2: the 8-sublane quantum was the whole gap)."""
    from hspmv.formats.sell import RankedSlabs

    # Large enough that the 512-sublane tile quantum is noise (~131k
    # rows); layout build only, no kernel run.
    mat = laplacian_2d(362)
    packed = PackedRanked.from_csr(mat)
    quant = RankedSlabs.from_csr(mat)
    assert packed.padding_ratio < 1.2
    assert quant.padding_ratio > 1.5
    assert packed.hbm_bytes < 0.85 * quant.hbm_bytes


def test_packed_two_ends_per_subtile():
    """Mixed sub-tiles holding two chunk completions (kc=4 chains) are
    segmented correctly."""
    # 3 nnz/row -> kc_raw ~3-4 -> MIN_KC=4 extents chain 2 ends per
    # sub-tile regularly.
    mat = random_banded(2000, 20, 3, seed=7)
    lay = PackedRanked.from_csr(mat)
    bmeta = np.asarray(lay.bmeta)
    assert (bmeta >> 8).max() == 2  # the shape this test exists for
    x = np.random.default_rng(2).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


def test_packed_tiny_single_chunk():
    """m < 128: one chunk, one partial row, carry never crosses."""
    mat = random_banded(90, 10, 4, seed=9)
    lay = PackedRanked.from_csr(mat)
    x = np.random.default_rng(9).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


def test_packed_empty_rows():
    """Rows with zero nonzeros still get MIN_KC slots and solve to 0."""
    mat = random_banded(400, 20, 5, seed=10)
    # Zero out two chunks' worth of rows structurally.
    indptr = mat.indptr.copy()
    keep = np.ones(mat.nnz, bool)
    lo, hi = mat.indptr[128], mat.indptr[256]
    keep[lo:hi] = False
    lens = np.diff(mat.indptr)
    lens[128:256] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(mat.indptr.dtype)
    from hspmv.formats.csr import CSRMatrix

    mat2 = CSRMatrix(indptr, mat.indices[keep], mat.data[keep], mat.shape)
    lay = PackedRanked.from_csr(mat2)
    x = np.random.default_rng(11).standard_normal(mat2.n).astype(np.float32)
    y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
    ref = mat2.matvec(x)
    assert np.all(y[128:256] == 0.0)
    assert _rel(y, ref) < 1e-6


def test_packed_grouped_matches_delta():
    """Grouped-window packed kernel (G absolute SMEM bases) reproduces
    the packed-delta kernel exactly on a stencil matrix."""
    from hspmv.bench.matrices import laplacian_2d

    mat = laplacian_2d(48)
    x = np.random.default_rng(13).standard_normal(mat.n).astype(np.float32)
    lg = PackedRanked.from_csr(mat, allow_groups=True)
    ld = PackedRanked.from_csr(mat, allow_groups=False)
    assert lg.group_code != 0 and ld.group_code == 0
    yg = np.asarray(spmv_packed(lg, jnp.asarray(x)))
    yd = np.asarray(spmv_packed(ld, jnp.asarray(x)))
    np.testing.assert_array_equal(yg, yd)
    assert _rel(yg, mat.matvec(x)) < 1e-6


def test_packed_layout_cache_roundtrip(tmp_path):
    """PackedRanked persists through the .npz layout cache (the
    reference's precomputed-artifact role, like sell/ranked)."""
    from hspmv.formats.sell import load_layout

    mat = random_banded(900, 40, 8, seed=2)
    lay = PackedRanked.from_csr(mat)
    path = str(tmp_path / "pk.npz")
    lay.save(path, mat, config=(0, 0, 1))
    back = load_layout(path, mat, config=(0, 0, 1))
    assert type(back) is PackedRanked
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    ya = np.asarray(spmv_packed(lay, jnp.asarray(x)))
    yb = np.asarray(spmv_packed(back, jnp.asarray(x)))
    assert np.array_equal(ya, yb)


def test_packed_tile_padup_correctness():
    """The slab stack ends at the last chunk's slots rounded up to one
    8-slot sub-tile, with no further padding, and the partial last
    sub-tile stays inert through the product."""
    mat = random_banded(80_000, 400, 9, seed=7)
    from hspmv.reorder import rcm

    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    lay = PackedRanked.from_csr(mat)
    total_k = int(lay.vals.shape[0])
    assert total_k % 8 == 0
    # The last chunk ends in the last sub-tile.
    last_end = 8 * (int(lay.out_row[-1]) // 2)
    assert last_end == total_k - 8
    x = np.random.default_rng(3).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


def test_packed_binned_matches_oracle():
    """Packed + column-binned slots (the r5 irregular-matrix mode):
    binned windows bound the gather span on matrices without band
    clusters while the mixed heights remove the 8-sublane quantum fill
    and the in-kernel emit replaces the segment-sum epilogue."""
    from hspmv.bench.matrices import random_general

    rng = np.random.default_rng(21)
    for mat, W in (
        (random_general(3000, 6, seed=3), 4),
        (random_general(1500, 3, seed=5), 2),
        (random_banded(2000, 300, 5, seed=6), 2),
    ):
        lay = PackedRanked.from_csr(mat, bin_blocks=W)
        x = rng.standard_normal(mat.n).astype(np.float32)
        y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
        assert _rel(y, mat.matvec(x)) < 1e-6, (mat.shape, W)


def test_packed_binned_cuts_quantum_fill():
    """On an irregular low-degree matrix the packed-binned layout must
    pad strictly less than the quantized ranked-binned layout at the
    same bin width (the fill the r4 file sweeps paid was mostly the
    8-sublane quantum)."""
    from hspmv.formats.sell import RankedSlabs

    mat = random_banded(60_000, 500, 4, seed=12)
    W = 2
    pk = PackedRanked.from_csr(mat, bin_blocks=W)
    rk = RankedSlabs.from_csr(mat, bin_blocks=W)
    assert pk.padding_ratio < 0.9 * rk.padding_ratio, (
        pk.padding_ratio, rk.padding_ratio
    )
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_packed(pk, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


def test_spmm_packed_matches_columnwise_spmv():
    """spmv_packed on (n, B) == B independent spmv_packed columns, across
    the delta-window, grouped-window, binned, and many-sub-tile paths."""
    from hspmv.kernels.packed import spmv_packed

    cases = [
        (laplacian_2d(40), dict()),
        (random_banded(640, 40, 8, seed=4), dict()),
        (laplacian_2d(150), dict()),      # chunks across sub-tiles
        (random_banded(800, 120, 10, seed=2), dict(bin_blocks=2)),
    ]
    for B in (1, 3, 8):
        for mat, kw in cases:
            lay = PackedRanked.from_csr(mat, **kw)
            X = np.random.default_rng(B).standard_normal(
                (mat.n, B)
            ).astype(np.float32)
            Y = np.asarray(spmv_packed(lay, jnp.asarray(X)))
            ref = np.stack(
                [mat.matvec(X[:, b]) for b in range(B)], axis=1
            )
            assert Y.shape == ref.shape
            assert _rel(Y, ref) < 1e-6, (mat.shape, B, kw)


def test_spmm_packed_grouped_path():
    from hspmv.kernels.packed import spmv_packed

    mat = laplacian_2d(48)
    lay_g = PackedRanked.from_csr(mat, allow_groups=True)
    assert lay_g.group_code != 0
    X = np.random.default_rng(0).standard_normal((mat.n, 4)).astype(
        np.float32
    )
    Y = np.asarray(spmv_packed(lay_g, jnp.asarray(X)))
    ref = np.stack([mat.matvec(X[:, b]) for b in range(4)], axis=1)
    assert _rel(Y, ref) < 1e-6
