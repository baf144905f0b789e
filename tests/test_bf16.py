"""bf16 value-storage mode (RankedSlabs/PackedRanked val_dtype).

The SpMV is bound by device memory, so halving the dominant slab-value
bytes is a lever past padding removal. Contract: the product widens
to f32 on load and must be bit-faithful to the bf16-ROUNDED
operator; drift vs the f32 oracle is exactly the value rounding (zero
for bf16-representable values, e.g. constant stencils). The reference
is fp32-only (spmv-csr/spmv.c:11-57) — this is a net-new opt-in.
"""

import copy

import jax.numpy as jnp
import numpy as np

from hspmv.bench.matrices import laplacian_2d, power_law, random_banded
from hspmv.formats.packed import PackedRanked
from hspmv.formats.sell import RankedSlabs, load_layout
from hspmv.kernels.packed import spmv_packed
from hspmv.kernels.sell import spmv_ranked


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _rounded(mat):
    r = copy.copy(mat)
    r.data = np.asarray(jnp.asarray(mat.data, jnp.bfloat16), np.float32)
    return r


def _cases():
    return [
        (laplacian_2d(40), True),  # bf16-representable values (+-1, 4)
        (random_banded(900, 50, 8, seed=5), False),
        (power_law(1200, 6, seed=2), False),
    ]


def test_bf16_ranked_bitfaithful_to_rounded_operator():
    for mat, representable in _cases():
        lay = RankedSlabs.from_csr(mat, val_dtype=jnp.bfloat16)
        assert lay.vals.dtype == jnp.bfloat16
        x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
        y = np.asarray(spmv_ranked(lay, jnp.asarray(x)))
        assert _rel(y, _rounded(mat).matvec(x)) < 1e-6
        if representable:
            assert _rel(y, mat.matvec(x)) < 1e-6


def test_bf16_packed_bitfaithful_to_rounded_operator():
    for mat, representable in _cases():
        lay = PackedRanked.from_csr(mat, val_dtype=jnp.bfloat16)
        assert lay.vals.dtype == jnp.bfloat16
        x = np.random.default_rng(1).standard_normal(mat.n).astype(np.float32)
        y = np.asarray(spmv_packed(lay, jnp.asarray(x)))
        assert _rel(y, _rounded(mat).matvec(x)) < 1e-6
        if representable:
            assert _rel(y, mat.matvec(x)) < 1e-6


def test_bf16_halves_value_traffic_accounting():
    mat = laplacian_2d(40)
    f32 = RankedSlabs.from_csr(mat)
    bf = RankedSlabs.from_csr(mat, val_dtype=jnp.bfloat16)
    assert bf.hbm_bytes == f32.hbm_bytes - 2 * f32.vals.size


def test_bf16_layout_cache_roundtrip(tmp_path):
    """npz cannot store ml_dtypes.bfloat16 natively; the cache views it
    as uint16 on save and restores the dtype on load."""
    mat = random_banded(700, 40, 8, seed=7)
    lay = RankedSlabs.from_csr(mat, val_dtype=jnp.bfloat16)
    path = str(tmp_path / "bf16.npz")
    lay.save(path, mat, config=(0, 0, 1, 1))
    back = load_layout(path, mat, config=(0, 0, 1, 1))
    assert back.vals.dtype == jnp.bfloat16
    assert np.array_equal(
        np.asarray(back.vals).view(np.uint16),
        np.asarray(lay.vals).view(np.uint16),
    )
    x = np.random.default_rng(2).standard_normal(mat.n).astype(np.float32)
    ya = np.asarray(spmv_ranked(lay, jnp.asarray(x)))
    yb = np.asarray(spmv_ranked(back, jnp.asarray(x)))
    assert np.array_equal(ya, yb)


def test_bf16_dia_exact_on_representable_stencil():
    """DIA + bf16: the Laplacian's +-1/4 values are bf16-representable,
    so the result matches the f32 oracle exactly; traffic accounting
    reflects the halved value bytes."""
    from hspmv.formats.dia import DiaSlabs
    from hspmv.kernels.dia import spmv_dia

    mat = laplacian_2d(40)  # natural order: 5 constant diagonals
    f32 = DiaSlabs.from_csr(mat)
    bf = DiaSlabs.from_csr(mat, val_dtype=jnp.bfloat16)
    assert bf.vals.dtype == jnp.bfloat16
    assert bf.hbm_bytes == f32.hbm_bytes - 2 * f32.vals.size
    x = np.random.default_rng(4).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_dia(bf, jnp.asarray(x)))
    assert _rel(y, mat.matvec(x)) < 1e-6


def test_bf16_sharded_ranked_matches_rounded_oracle():
    """val_dtype flows through the distributed flagship: every shard
    stores bf16 slabs; the stacked kernel widens on load."""
    import jax
    import pytest

    from hspmv.dist.sharding import ShardedRanked, spmv_sharded

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:4]), ("rows",))
    mat = random_banded(2000, 50, 8, seed=9)
    lay = ShardedRanked.build(mat, 4, val_dtype=jnp.bfloat16)
    assert lay.vals.dtype == jnp.bfloat16
    lay = lay.device_put(mesh)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    xp = np.zeros(lay.padded_m, np.float32)
    xp[: mat.n] = x
    import jax.numpy as jnp_

    xj = jax.device_put(
        jnp_.asarray(xp),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rows")),
    )
    y = np.asarray(spmv_sharded(lay, xj, mesh))[: mat.m]
    assert _rel(y, _rounded(mat).matvec(x)) < 1e-6


def test_bf16_cli_fallback_validates_vs_f32_oracle(capsys):
    """--val-dtype bf16 on a matrix whose span exceeds the packed-delta
    range drops to the f32 sell kernel — the validation oracle must
    follow the layout actually built (an exact f32 result judged
    against the rounded operator would report spurious wrongs)."""
    from hspmv.tools import spmv

    # 50k scattered columns with cluster-aligned slots (bin 0) spans
    # ~390 x blocks per sub-tile — past the 256-block packed-delta
    # range, so the ranked build deterministically falls back to sell.
    rc = spmv.main([
        "synthetic:general_50k", "--kernel", "ranked", "--val-dtype",
        "bf16", "--bin-blocks", "0", "--sigma", "0", "--rcm", "never",
        "--validate-only",
    ])
    out = capsys.readouterr().out
    assert "falling back to sell" in out
    assert "validated vs the f32 oracle" in out
    assert rc == 0


def test_bf16_spmm_inherits_cast():
    """spmm over a bf16 RankedSlabs layout widens on load too."""
    from hspmv.kernels.sell import spmv_ranked

    mat = laplacian_2d(32)
    lay = RankedSlabs.from_csr(mat, val_dtype=jnp.bfloat16)
    X = np.random.default_rng(3).standard_normal((mat.n, 4)).astype(np.float32)
    Y = np.asarray(spmv_ranked(lay, jnp.asarray(X)))
    Y_oracle = np.stack(
        [_rounded(mat).matvec(X[:, j]) for j in range(4)], axis=1
    )
    assert _rel(Y, Y_oracle) < 1e-6
