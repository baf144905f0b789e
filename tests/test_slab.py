"""The shared slab body (kernels/slab.py) against NumPy oracles.

Every SELL-family layout — absolute columns (sell), window-relative
columns with packed per-sublane deltas (ranked) or grouped absolute
bases (ranked-grouped), and back-to-back mixed heights (packed) — runs
the same gather / multiply / reduce in plain XLA. Each is checked on the
small suite in f32 and bf16 values (bf16 against the bf16-rounded
operator, the layouts' accuracy contract)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hspmv.bench.matrices import (
    laplacian_2d, power_law, random_banded, random_general,
)
from hspmv.formats.packed import PackedRanked
from hspmv.formats.sell import RankedSlabs, SellSlabs
from hspmv.kernels.packed import spmv_packed
from hspmv.kernels.sell import spmv_ranked, spmv_sell, spmv_sell_reference
from hspmv.kernels.slab import (
    packed_slot_chunks, ranked_columns, sublane_bases,
)

MATS = {
    "lap2d_24": lambda: laplacian_2d(24),
    "banded_1k": lambda: random_banded(1000, 40, 8, seed=1),
    "general_1k": lambda: random_general(1000, 6, seed=2),
    "powerlaw_2k": lambda: power_law(2000, 6, seed=3),
}


def _rel(y, r):
    return np.linalg.norm(y - r) / max(np.linalg.norm(r), 1e-30)


def _build(layout, mat, vdt):
    if layout == "sell":
        return SellSlabs.from_csr(mat), spmv_sell
    if layout == "ranked":
        return RankedSlabs.from_csr(
            mat, allow_groups=False, val_dtype=vdt
        ), spmv_ranked
    if layout == "ranked-grouped":
        lay = RankedSlabs.from_csr(mat, allow_groups=True, val_dtype=vdt)
        return lay, spmv_ranked
    return PackedRanked.from_csr(mat, val_dtype=vdt), spmv_packed


# SellSlabs stores f32 values only.
LAYOUT_DTYPES = [("sell", "f32")] + [
    (lay, dt) for lay in ("ranked", "ranked-grouped", "packed")
    for dt in ("f32", "bf16")
]


@pytest.mark.parametrize("layout,dtype", LAYOUT_DTYPES)
@pytest.mark.parametrize("name", list(MATS))
def test_slab_body_matches_oracle(name, dtype, layout):
    mat = MATS[name]()
    vdt = jnp.bfloat16 if dtype == "bf16" else None
    try:
        lay, fn = _build(layout, mat, vdt)
    except ValueError as e:  # packed-delta range: a documented refusal
        pytest.skip(f"layout refuses this structure: {e}")
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(fn(lay, jnp.asarray(x)))
    assert y.shape == (mat.m,) and y.dtype == np.float32
    oracle = mat if vdt is None else mat.rounded(vdt)
    assert _rel(y, oracle.matvec(x)) < 1e-6


@pytest.mark.parametrize("name", list(MATS))
def test_ranked_columns_decode_to_absolute(name):
    """Decoded window-relative columns equal the absolute SELL columns
    on every real slot (grouped and packed-delta encodings alike)."""
    mat = MATS[name]()
    ref = SellSlabs.from_csr(mat, align=True)
    for groups in (True, False):
        lay = RankedSlabs.from_csr(mat, allow_groups=groups)
        cols = np.asarray(ranked_columns(lay))[: ref.vals.shape[0]]
        real = np.asarray(ref.vals) != 0
        np.testing.assert_array_equal(cols[real], np.asarray(ref.cols)[real])
        assert np.asarray(sublane_bases(lay)).min() >= 0


def test_sell_matches_accumulation_reference():
    mat = random_banded(1500, 60, 9, seed=5)
    lay = SellSlabs.from_csr(mat)
    x = np.random.default_rng(1).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_sell(lay, jnp.asarray(x)))
    assert _rel(y, spmv_sell_reference(lay, x)) < 1e-6


def test_packed_slot_chunks_are_sorted_and_complete():
    mat = random_banded(3000, 50, 7, seed=6)
    lay = PackedRanked.from_csr(mat)
    sc = np.asarray(packed_slot_chunks(lay))
    assert sc.shape == (lay.vals.shape[0],)
    assert np.all(np.diff(sc) >= 0)
    assert set(range(lay.num_chunks)) <= set(sc.tolist())
    # Each chunk's slot rows hold exactly that chunk's nonzeros.
    vals = np.asarray(lay.vals)
    for c in (0, lay.num_chunks // 2, lay.num_chunks - 1):
        rows = slice(c * 128, min((c + 1) * 128, mat.m))
        nnz_c = int(mat.indptr[rows.stop] - mat.indptr[rows.start])
        assert int((vals[sc == c] != 0).sum()) == nnz_c


@pytest.mark.parametrize("layout", ["ranked", "packed"])
@pytest.mark.parametrize("name", ["banded_1k", "powerlaw_2k"])
def test_slab_body_spmm(name, layout):
    mat = MATS[name]()
    B = 5
    X = np.random.default_rng(2).standard_normal((mat.n, B)).astype(np.float32)
    if layout == "ranked":
        Y = np.asarray(spmv_ranked(RankedSlabs.from_csr(mat), jnp.asarray(X)))
    else:
        Y = np.asarray(spmv_packed(PackedRanked.from_csr(mat), jnp.asarray(X)))
    Y_ref = np.stack([mat.matvec(X[:, b]) for b in range(B)], axis=1)
    assert Y.shape == (mat.m, B)
    assert _rel(Y, Y_ref) < 1e-6
