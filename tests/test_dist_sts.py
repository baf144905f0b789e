"""Distributed triangular solve: block back-substitution over the mesh
(net-new vs the reference, whose STS is single-process OpenMP —
spmv-csrk/csrk.cpp:79-145)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hspmv.bench.matrices import laplacian_2d, random_banded
from hspmv.dist.sts import ShardedLowerSolve, sts_solve_sharded
from hspmv.sts.host import build_sts, compute_b
from hspmv.sts.solve import lower_solve_reference


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / max(
        np.linalg.norm(np.asarray(b, np.float64)), 1e-30
    )


def _mesh_or_skip(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.asarray(jax.devices()[:n]), ("rows",))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_solve_matches_reference(n_dev):
    mesh = _mesh_or_skip(n_dev)
    mat = random_banded(4000, 30, 6, seed=3)
    # COLOR: few large packs -> small pack padding, real rows on every
    # shard (LS on banded systems yields hundreds of 128-padded packs).
    sys = build_sts(mat, order_type="COLOR")
    rng = np.random.default_rng(1)
    b = rng.standard_normal(mat.m).astype(np.float32)
    x_ref = lower_solve_reference(sys, b)

    lay, pad_index = ShardedLowerSolve.build(sys, b, n_dev)
    assert lay.rows_per_shard * (n_dev - 1) < lay.padded_m
    lp = lay.device_put(mesh)
    x_pad = np.asarray(sts_solve_sharded(lp, mesh))
    assert _rel(x_pad[pad_index], x_ref) < 1e-5


def test_sharded_solve_hybrid_mesh():
    """Over the multi-host (hosts, rows) mesh: the all-gather exchange
    and owner indexing span the flattened tuple axis."""
    from hspmv.dist.multihost import make_hybrid_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_hybrid_mesh(num_hosts=2)
    axis = ("hosts", "rows")
    mat = laplacian_2d(90)  # 8100 rows
    sys = build_sts(mat, order_type="COLOR")
    b = compute_b(sys.lower)  # x_exact = ones
    lay, pad_index = ShardedLowerSolve.build(sys, b, 8)
    lp = lay.device_put(mesh, axis)
    x_pad = np.asarray(sts_solve_sharded(lp, mesh, axis))
    assert _rel(x_pad[pad_index], np.ones(mat.m)) < 1e-5


def test_sharded_solve_many_packs_ls():
    """LS ordering on a banded system yields many 128-padded packs:
    shard boundaries land mid-pack-sequence and late shards hold mostly
    padding — alignment and the pad-row identity solve must hold."""
    mesh = _mesh_or_skip(4)
    mat = random_banded(900, 25, 5, seed=7)
    sys = build_sts(mat, order_type="LS")
    rng = np.random.default_rng(8)
    b = rng.standard_normal(mat.m).astype(np.float32)
    x_ref = lower_solve_reference(sys, b)
    lay, pad_index = ShardedLowerSolve.build(sys, b, 4)
    lp = lay.device_put(mesh)
    x_pad = np.asarray(sts_solve_sharded(lp, mesh))
    assert _rel(x_pad[pad_index], x_ref) < 1e-5
