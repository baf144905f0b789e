"""Cross-kernel consistency fuzz: every applicable kernel must agree
with the serial oracle on the same randomized matrix.

The per-kernel suites test each path in isolation; this sweep catches
integration skew (layout builders disagreeing on padding semantics,
planner-parameter combinations nobody tested individually). Seeded —
failures reproduce.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hspmv.bench.matrices import (
    laplacian_2d, power_law, random_banded, random_general,
    variable_stencil,
)
from hspmv.formats.csr import CSRMatrix


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cases():
    rng = np.random.default_rng(2024)
    return [
        ("lap2d", laplacian_2d(37)),
        ("varstencil", variable_stencil(29, seed=7)),
        ("banded", random_banded(1100, 70, 9, seed=int(rng.integers(1 << 20)))),
        ("banded_sparse", random_banded(640, 25, 3, seed=5)),
        ("general", random_general(900, 7, seed=3)),
        ("powerlaw", power_law(1500, 6, max_len=96, seed=4)),
    ]


@pytest.mark.parametrize("name,mat", _cases(), ids=lambda v: v if isinstance(v, str) else "")
def test_all_kernels_agree(name, mat):
    from hspmv.formats.packed import PackedRanked
    from hspmv.formats.sell import RankedSlabs, SellSlabs
    from hspmv.kernels.packed import spmv_packed
    from hspmv.kernels.sell import spmv_ranked, spmv_sell
    from hspmv.kernels.segsum import SegsumLayout, spmv_segsum
    from hspmv.reorder.rcm import rcm

    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    xj = jnp.asarray(x)
    y_ref = mat.matvec(x)

    ran = {"segsum": np.asarray(spmv_segsum(SegsumLayout.from_csr(mat), xj))}
    ran["sell"] = np.asarray(
        spmv_sell(SellSlabs.from_csr(mat), xj)
    )
    for bins in (0, 4, 16):
        try:
            lay = RankedSlabs.from_csr(mat, bin_blocks=bins)
        except ValueError:
            continue  # packed-delta span exceeded: legitimate rejection
        ran[f"ranked_w{bins}"] = np.asarray(
            spmv_ranked(lay, xj)
        )
    try:
        ran["packed"] = np.asarray(
            spmv_packed(PackedRanked.from_csr(mat), xj)
        )
    except ValueError:
        pass

    assert len(ran) >= 3, f"{name}: too few kernels ran ({sorted(ran)})"
    for kname, y in ran.items():
        assert _rel(y, y_ref) < 1e-6, (name, kname)


def test_dia_agrees_where_applicable():
    from hspmv.formats.dia import DiaSlabs
    from hspmv.kernels.dia import spmv_dia

    # DIA on the natural-order stencils.
    for mat in (laplacian_2d(33), variable_stencil(31, seed=2)):
        x = np.random.default_rng(1).standard_normal(mat.n).astype(
            np.float32
        )
        y = np.asarray(spmv_dia(DiaSlabs.from_csr(mat), jnp.asarray(x)))
        assert _rel(y, mat.matvec(x)) < 1e-6


def test_rectangular_kernels_agree():
    """m != n (the reference's lp1-class rectangular inputs)."""
    from hspmv.formats.sell import RankedSlabs, SellSlabs
    from hspmv.kernels.sell import spmv_ranked, spmv_sell
    from hspmv.kernels.segsum import SegsumLayout, spmv_segsum

    rng = np.random.default_rng(11)
    m, n, nnz = 900, 2300, 6200
    rows = np.sort(rng.integers(0, m, nnz))
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    mat = CSRMatrix.from_coo(rows, cols, vals, (m, n))
    x = rng.standard_normal(n).astype(np.float32)
    xj = jnp.asarray(x)
    y_ref = mat.matvec(x)
    for mk in (
        lambda: spmv_segsum(SegsumLayout.from_csr(mat), xj),
        lambda: spmv_sell(SellSlabs.from_csr(mat), xj),
        lambda: spmv_ranked(
            RankedSlabs.from_csr(mat, bin_blocks=4), xj
        ),
    ):
        assert _rel(np.asarray(mk()), y_ref) < 1e-6


@pytest.mark.parametrize(
    "name,mat", _cases(), ids=lambda v: v if isinstance(v, str) else ""
)
def test_spmm_kernels_agree(name, mat):
    """SpMM (spmv_ranked / spmv_packed on an (n, B) X) vs column-wise oracle on every fuzz
    case where the layouts build (B=5: an odd batch width)."""
    from hspmv.formats.packed import PackedRanked
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.packed import spmv_packed
    from hspmv.kernels.sell import spmv_ranked
    from hspmv.reorder.rcm import rcm

    B = 5
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    X = np.random.default_rng(1).standard_normal((mat.n, B)).astype(
        np.float32
    )
    Xj = jnp.asarray(X)
    ref = np.stack([mat.matvec(X[:, b]) for b in range(B)], axis=1)
    ran = {}
    for bins in (0, 4):
        try:
            lay = RankedSlabs.from_csr(mat, bin_blocks=bins)
        except ValueError:
            continue
        ran[f"spmm_ranked_w{bins}"] = np.asarray(
            spmv_ranked(lay, Xj)
        )
    for bins in (0, 4):
        try:
            lay = PackedRanked.from_csr(mat, bin_blocks=bins)
        except ValueError:
            continue
        ran[f"spmm_packed_w{bins}"] = np.asarray(
            spmv_packed(lay, Xj)
        )
    assert ran, f"{name}: no SpMM layout built"
    for kname, Y in ran.items():
        assert _rel(Y, ref) < 1e-6, (name, kname)
