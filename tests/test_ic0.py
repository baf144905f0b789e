"""IC(0) incomplete Cholesky + preconditioned CG (sts/ic0.py).

The reference's incomplete_choloskey is structural-only and its STS
driver is disabled (spmv-csrk/spmv.cpp:219-234); the numeric factor and
the jitted PCG loop are net-new, and they are the production consumer
of the chunk-sequential triangular-solve kernels.
"""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve_triangular

from hspmv.bench.matrices import laplacian_2d, random_banded
from hspmv.sts.host import split_lu
from hspmv.sts.ic0 import (
    IC0Preconditioner, _ic0_numpy, ic0_factor, pcg_ic0_solve,
)


def test_ic0_native_numpy_parity_and_pattern():
    import pytest

    from hspmv.reorder import native

    if not native.available():
        pytest.skip("native core unavailable; parity would be vacuous")
    mat = random_banded(800, 40, 8, seed=3)
    L, bad = ic0_factor(mat)  # native path (available() checked above)
    assert bad == 0  # diagonally dominant SPD: no pivot shifts
    lower, _ = split_lu(mat)
    vals_np, bad_np = _ic0_numpy(lower.indptr, lower.indices, lower.data)
    assert bad_np == 0
    assert np.array_equal(np.asarray(L.data), vals_np)  # bit-exact parity
    # Defining property of IC(0): L L^T == A on A's sparsity pattern.
    Ls = L.to_scipy().astype(np.float64)
    A = mat.to_scipy().astype(np.float64)
    pat = A.copy()
    pat.data[:] = 1.0
    diff = (Ls @ Ls.T).tocsr().multiply(pat) - A
    assert abs(diff).max() < 1e-5


def test_ic0_breakdown_shift_is_counted():
    """An indefinite 'SPD-shaped' matrix must not crash: nonpositive
    pivots are shifted and counted."""
    mat = random_banded(300, 20, 6, seed=1, diagonally_dominant=False)
    L, bad = ic0_factor(mat)
    assert bad > 0
    assert np.isfinite(np.asarray(L.data)).all()
    diag = L.data[L.indptr[1:].astype(np.int64) - 1]
    assert (diag > 0).all()


def test_ic0_apply_matches_scipy_two_solves():
    mat = random_banded(700, 30, 8, seed=5)
    pre = IC0Preconditioner.build(mat)
    assert pre.breakdowns == 0
    L, _ = ic0_factor(mat)
    Ls = L.to_scipy().astype(np.float64)
    r = np.random.default_rng(0).standard_normal(mat.m).astype(np.float32)
    y = spsolve_triangular(Ls.tocsr(), r.astype(np.float64), lower=True)
    z_ref = spsolve_triangular(sp.csr_matrix(Ls.T), y, lower=False)
    z = np.asarray(pre.apply(jnp.asarray(r)))
    assert np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref) < 1e-6


def test_pcg_ic0_beats_plain_cg():
    """On the Laplacian (the slow-CG class) IC(0) must cut the residual
    by orders of magnitude at equal iteration count."""
    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked
    from hspmv.reorder.rcm import rcm

    mat = laplacian_2d(48)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    lay = RankedSlabs.from_csr(mat)
    b = np.ones(mat.m, np.float32)
    bj = jnp.asarray(b)

    pre = IC0Preconditioner.build(mat)
    x, _ = pcg_ic0_solve(lay, bj, pre, iters=30)
    res_ic0 = np.linalg.norm(mat.matvec(np.asarray(x)) - b)

    x = jnp.zeros_like(bj)
    r = p = bj
    rz = jnp.vdot(r, r)
    for _ in range(30):
        Ap = spmv_ranked(lay, p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rz2 = jnp.vdot(r, r)
        p = r + (rz2 / rz) * p
        rz = rz2
    res_cg = np.linalg.norm(mat.matvec(np.asarray(x)) - b)
    assert res_ic0 < res_cg / 100


def test_solve_cli_ic0(capsys):
    from hspmv.tools import solve

    rc = solve.main([
        "synthetic:banded_1k", "--iters", "25", "--precond", "ic0",
        "--devices", "1",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "breakdowns=0" in out


def test_pcg_ic0_sharded_matches_single_chip():
    """Distributed exact IC(0): two block back-substitution chains per
    iteration; must converge like the single-chip PCG."""
    import jax
    import pytest

    from hspmv.dist.sharding import (
        ShardedRanked, make_row_mesh, shard_vector,
    )
    from hspmv.reorder.rcm import rcm
    from hspmv.sts.ic0 import ShardedIC0Preconditioner, pcg_ic0_sharded

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mat = random_banded(3000, 50, 8, seed=2)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    D = 4
    mesh = make_row_mesh(jax.devices()[:D])
    lay = ShardedRanked.build(mat, D).device_put(mesh)
    pre = ShardedIC0Preconditioner.build(mat, D, lay.padded_m)
    assert pre.breakdowns == 0
    b = np.ones(mat.m, np.float32)
    bp = np.zeros(lay.padded_m, np.float32)
    bp[: mat.m] = b
    x, _ = pcg_ic0_sharded(lay, shard_vector(bp, mesh), pre, mesh, iters=25)
    x = np.asarray(x)[: mat.m]
    resid = np.linalg.norm(mat.matvec(x) - b) / np.sqrt(mat.m)
    assert resid < 1e-5


def _block_jacobi_oracle(mat, D, rows_per_shard, r):
    """Blockwise (L_d L_d^T)^-1 r via scipy triangular solves (f64)."""
    z = np.zeros_like(r, dtype=np.float64)
    for d in range(D):
        r0 = min(d * rows_per_shard, mat.m)
        r1 = min((d + 1) * rows_per_shard, mat.m)
        if r1 == r0:
            continue
        from hspmv.formats.csr import CSRMatrix

        block = CSRMatrix.from_scipy(
            mat.to_scipy().tocsr()[r0:r1, r0:r1].tocsr()
        )
        L, bad = ic0_factor(block)
        assert bad == 0
        Ls = L.to_scipy().astype(np.float64).tocsr()
        rb = r[d * rows_per_shard : d * rows_per_shard + (r1 - r0)]
        y = spsolve_triangular(Ls, rb.astype(np.float64), lower=True)
        z[d * rows_per_shard : d * rows_per_shard + (r1 - r0)] = (
            spsolve_triangular(sp.csr_matrix(Ls.T), y, lower=False)
        )
    return z


def test_block_jacobi_ic0_apply_matches_blockwise_scipy():
    """apply() == blockdiag((L_d L_d^T)^-1) r, including a partially
    filled last real shard and fully padded trailing shards (D=8 over
    3000 rows leaves shards 3..7 empty)."""
    import jax
    import pytest

    from hspmv.dist.sharding import (
        ShardedRanked, make_row_mesh, shard_vector,
    )
    from hspmv.sts.ic0 import BlockJacobiIC0Preconditioner

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mat = random_banded(3000, 50, 8, seed=7)
    D = 8
    mesh = make_row_mesh(jax.devices()[:D])
    lay = ShardedRanked.build(mat, D)
    pre = BlockJacobiIC0Preconditioner.build(
        mat, D, lay.padded_m
    ).device_put(mesh)
    assert pre.breakdowns == 0

    rng = np.random.default_rng(0)
    r = np.zeros(lay.padded_m, np.float32)
    r[: mat.m] = rng.standard_normal(mat.m).astype(np.float32)
    z = np.asarray(
        pre.apply(shard_vector(r, mesh), mesh)
    )
    z_ref = _block_jacobi_oracle(mat, D, pre.rows_per_shard, r)
    assert np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref) < 1e-6
    # Padding rows stay exactly zero.
    assert not z[mat.m :].any()


def test_pcg_block_jacobi_ic0_converges():
    """Zero-communication block-Jacobi IC(0) through the same sharded
    PCG loop: converges on the banded class (weaker than exact IC(0) by
    construction, but well ahead of plain CG)."""
    import jax
    import pytest

    from hspmv.dist.sharding import (
        ShardedRanked, make_row_mesh, shard_vector,
    )
    from hspmv.reorder.rcm import rcm
    from hspmv.sts.ic0 import (
        BlockJacobiIC0Preconditioner, pcg_ic0_sharded,
    )

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mat = random_banded(3000, 50, 8, seed=2)
    mat = mat.permuted(rcm(mat.indptr, mat.indices))
    D = 4
    mesh = make_row_mesh(jax.devices()[:D])
    lay = ShardedRanked.build(mat, D).device_put(mesh)
    pre = BlockJacobiIC0Preconditioner.build(
        mat, D, lay.padded_m
    ).device_put(mesh)
    assert pre.breakdowns == 0
    b = np.ones(mat.m, np.float32)
    bp = np.zeros(lay.padded_m, np.float32)
    bp[: mat.m] = b
    x, _ = pcg_ic0_sharded(lay, shard_vector(bp, mesh), pre, mesh, iters=25)
    x = np.asarray(x)[: mat.m]
    resid = np.linalg.norm(mat.matvec(x) - b) / np.sqrt(mat.m)
    assert resid < 1e-5


def test_solve_cli_ic0_distributed(capsys):
    import jax
    import pytest

    from hspmv.tools import solve

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rc = solve.main([
        "synthetic:banded_1k", "--iters", "25", "--precond", "ic0",
        "--devices", "4",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "distributed, D=4" in out


def test_solve_cli_ic0_block_jacobi(capsys):
    import jax
    import pytest

    from hspmv.tools import solve

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rc = solve.main([
        "synthetic:banded_1k", "--iters", "25", "--precond", "ic0-bj",
        "--devices", "4",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "block-Jacobi, D=4" in out
