"""STS subsystem tests: pack invariants, oracle parity, device solve.

Reference behavior under test: preprocessingForSTS pack construction
(spmv-csrk/csrk.cpp:1522-1966), incomplete_choloskey structural split
(csrk.cpp:708-789), lowerSTS forward solve (csrk.cpp:79-145), compute_b
(csrk.cpp:791-808).
"""

import numpy as np
import pytest

from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
from hspmv.sts.host import (
    build_sts,
    check_error,
    compute_b,
    find_levels,
    greedy_color,
    split_lu,
)
from hspmv.sts.solve import LowerSolveLayout, lower_solve, lower_solve_reference


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / max(
        np.linalg.norm(np.asarray(b, np.float64)), 1e-30
    )


# Small sizes keep the serial oracle and the CPU solve fast.
MATS = {
    "lap2d": laplacian_2d(12),
    "banded": random_banded(200, 18, 6, seed=1),
    "general": random_general(100, 4, seed=2),
}


def test_split_lu_partition():
    mat = MATS["banded"]
    L, U = split_lu(mat)
    assert L.nnz + U.nnz == mat.nnz + mat.m  # diagonal in both
    # L strictly lower + diag; U strictly upper + diag.
    rows_l = np.repeat(np.arange(L.m), L.row_lengths)
    assert (L.indices <= rows_l).all()
    rows_u = np.repeat(np.arange(U.m), U.row_lengths)
    assert (U.indices >= rows_u).all()
    # Dense reconstruction: L + U - diag == A.
    dense = L.to_dense() + U.to_dense() - np.diag(np.diag(mat.to_dense()))
    np.testing.assert_allclose(dense, mat.to_dense(), rtol=1e-6)


def test_find_levels_is_valid_schedule():
    mat = MATS["lap2d"]
    lev = find_levels(mat.indptr, mat.indices)
    rows = np.repeat(np.arange(mat.m), mat.row_lengths)
    cols = mat.indices.astype(np.int64)
    strict = cols < rows
    # Every dependency sits in a strictly earlier level.
    assert (lev[cols[strict]] < lev[rows[strict]]).all()


def test_greedy_color_proper():
    mat = MATS["general"]
    col = greedy_color(mat.indptr, mat.indices)
    rows = np.repeat(np.arange(mat.m), mat.row_lengths)
    cols = mat.indices.astype(np.int64)
    off = rows != cols
    assert (col[rows[off]] != col[cols[off]]).all()


@pytest.mark.parametrize("order_type", ["LS", "COLOR"])
@pytest.mark.parametrize("name", list(MATS))
def test_packs_are_independent_sets(order_type, name):
    """The invariant the level-scheduled solve relies on: no L entries between rows
    of the same pack (after the pack permutation)."""
    sys = build_sts(MATS[name], order_type=order_type)
    pack_of = np.zeros(sys.matrix.m, dtype=np.int64)
    for p in range(sys.num_packs):
        pack_of[sys.pack_ptr[p] : sys.pack_ptr[p + 1]] = p
    L = sys.lower
    rows = np.repeat(np.arange(L.m), L.row_lengths)
    cols = L.indices.astype(np.int64)
    strict = cols < rows
    assert (pack_of[cols[strict]] < pack_of[rows[strict]]).all()


@pytest.mark.parametrize("order_type", ["LS", "COLOR"])
def test_sts_k3_packs_are_independent_sets(order_type):
    sys = build_sts(MATS["banded"], order_type=order_type, k=3, sup_row_sizes=(8,))
    pack_of = np.zeros(sys.matrix.m, dtype=np.int64)
    for p in range(sys.num_packs):
        pack_of[sys.pack_ptr[p] : sys.pack_ptr[p + 1]] = p
    L = sys.lower
    rows = np.repeat(np.arange(L.m), L.row_lengths)
    cols = L.indices.astype(np.int64)
    strict = cols < rows
    assert (pack_of[cols[strict]] < pack_of[rows[strict]]).all()
    # Permutation is a bijection.
    assert np.array_equal(np.sort(sys.perm), np.arange(sys.matrix.m))


@pytest.mark.parametrize("order_type", ["LS", "COLOR"])
@pytest.mark.parametrize("name", list(MATS))
def test_lower_solve_matches_oracle(order_type, name):
    sys = build_sts(MATS[name], order_type=order_type)
    b = compute_b(sys.lower)  # x_exact = ones
    x_ref = lower_solve_reference(sys, b)
    # b is assembled in float32, so exact-ones recovery is fp32-limited.
    np.testing.assert_allclose(x_ref, np.ones(sys.matrix.m), rtol=1e-5)

    layout = LowerSolveLayout.build(sys, b)
    x = np.asarray(lower_solve(layout))
    assert _rel(x, x_ref) < 1e-5
    assert abs(check_error(x)) < 1e-2 * sys.matrix.m


def test_lower_solve_random_rhs():
    mat = MATS["banded"]
    sys = build_sts(mat, order_type="LS")
    rng = np.random.default_rng(0)
    b = rng.standard_normal(mat.m).astype(np.float32)
    x_ref = lower_solve_reference(sys, b)
    layout = LowerSolveLayout.build(sys, b)
    x = np.asarray(lower_solve(layout))
    assert _rel(x, x_ref) < 1e-5


def test_lower_solve_k3():
    mat = MATS["lap2d"]
    sys = build_sts(mat, order_type="LS", k=3, sup_row_sizes=(8,))
    b = compute_b(sys.lower)
    layout = LowerSolveLayout.build(sys, b)
    x = np.asarray(lower_solve(layout))
    assert _rel(x, np.ones(mat.m)) < 1e-5


def test_scattered_dependencies_use_binned_path():
    """Level-scheduled random-banded system: the level permutation
    scatters each row's parents across all earlier packs. The solve
    gathers them from x at absolute columns, one step per level (a
    level never splits across a step boundary mid-chunk)."""
    import numpy as np

    from hspmv.bench.matrices import random_banded
    from hspmv.sts.host import build_sts, compute_b
    from hspmv.sts.solve import (
        LowerSolveLayout, lower_solve, lower_solve_reference,
    )

    smat = random_banded(1536, 200, 8, seed=0)
    sysm = build_sts(smat, order_type="LS")
    b = compute_b(sysm.lower)
    lay = LowerSolveLayout.build(sysm, b)
    assert lay.sched.num_steps >= sysm.num_packs  # >= one step per level
    x = np.asarray(lower_solve(lay))
    x_ref = lower_solve_reference(sysm, b)
    assert int(np.sum(np.abs(x - x_ref) > 0.01)) == 0
    rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-6


@pytest.mark.slow
def test_scattered_dependencies_use_binned_path_full():
    """Full-size (32k-feeder-class) variant of the scattered-solve test."""
    from hspmv.bench.matrices import random_banded
    from hspmv.sts.host import build_sts, compute_b
    from hspmv.sts.solve import (
        LowerSolveLayout, lower_solve, lower_solve_reference,
    )

    smat = random_banded(4096, 300, 10, seed=0)
    sysm = build_sts(smat, order_type="LS")
    b = compute_b(sysm.lower)
    lay = LowerSolveLayout.build(sysm, b)
    assert lay.sched.num_steps >= sysm.num_packs
    x = np.asarray(lower_solve(lay))
    x_ref = lower_solve_reference(sysm, b)
    assert int(np.sum(np.abs(x - x_ref) > 0.01)) == 0


@pytest.mark.parametrize("order_type", ["LS", "COLOR"])
@pytest.mark.parametrize("step_scale", [1, 4])
def test_level_solve_split_packs(order_type, step_scale):
    """Packs larger than a step split across several steps (forced
    small T); the level-scheduled solve must still match the serial
    oracle."""
    from hspmv.bench.matrices import random_banded
    from hspmv.sts.solve import (
        LevelSchedule, chunk_packs, lower_solve_blocks, pack_padding,
    )

    mat = random_banded(3000, 60, 8, seed=4)
    sysm = build_sts(mat, order_type=order_type)
    b = compute_b(sysm.lower)
    lay = LowerSolveLayout.build(sysm, b)
    sc = np.asarray(lay.slabs.sub_chunk)
    qmax = int(np.bincount(sc[sc < lay.slabs.num_chunks]).max())
    _, pad_start = pack_padding(sysm)
    sched = LevelSchedule.build(
        sc, chunk_packs(pad_start, lay.slabs.num_chunks), T=qmax * step_scale
    )
    assert sched.num_steps >= sysm.num_packs
    x = np.asarray(
        lower_solve_blocks(lay.slabs, sched, lay.b_scale)
    ).reshape(-1)[np.asarray(lay.pad_index)]
    x_ref = lower_solve_reference(sysm, b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-6


def test_choose_step_trades_steps_for_masked_work():
    from hspmv.sts.solve import STEP_COST_SUBTILES, choose_step

    # Many tiny packs: the smallest admissible step.
    assert choose_step(np.ones(500, np.int64), 1) == 1
    # One huge pack: a step as large as the pack beats many steps.
    assert choose_step(np.array([4096]), 1) == 4096
    # Never below the largest chunk, always a power of two.
    T = choose_step(np.array([3, 5, 700]), 3)
    assert T >= 3 and T & (T - 1) == 0
    assert STEP_COST_SUBTILES > 0


def test_stacked_schedules_pad_with_noop_steps():
    from hspmv.sts.solve import LevelSchedule, stack_schedules

    a = LevelSchedule.build(np.array([0, 0, 1, 2, 3]), np.array([0, 0, 1, 1]), T=4)
    b = LevelSchedule.build(np.array([0, 1, 4]), np.array([0, 1, 2, 3]), T=4)
    st = stack_schedules([a, b], num_subtiles=6, num_chunks=4)
    assert st.step_s0.shape == (2, max(a.num_steps, b.num_steps))
    assert st.sub_step.shape == (2, 6)
    short = int(np.argmin([a.num_steps, b.num_steps]))
    pad = np.asarray(st.step_nc)[short][min(a.num_steps, b.num_steps):]
    assert (pad == 0).all()  # no-op steps finalize no chunk


def test_upper_solve_scipy_parity():
    """Backward substitution via row+column reversal: solving the
    reversed system's LOWER triangle equals scipy's upper solve on the
    original (arbitrary rhs, not just the x=ones protocol).

    Triangle-exact semantics need a TRIANGULAR input + LS order +
    sort_packs=False: build_sts splits AFTER permuting (the reference's
    incomplete_choloskey-after-reorderA semantics, csrk.cpp:548-789),
    so a pack-size sort can flip full-matrix entries across the
    diagonal — the solved system is then tril(P A P^T) by design, not
    P tril(A) P^T. Level order preserves dependency edges exactly."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from hspmv.bench.matrices import random_banded
    from hspmv.formats.csr import CSRMatrix
    from hspmv.sts.host import build_sts, reversed_for_upper
    from hspmv.sts.solve import LowerSolveLayout, lower_solve

    full = random_banded(700, 40, 8, seed=11)
    U = sp.triu(full.to_scipy(), format="csr")
    mat = CSRMatrix.from_scipy(U)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(mat.m).astype(np.float32)

    x_ref = spsolve_triangular(
        U.astype(np.float64), b.astype(np.float64), lower=False
    )

    mat_r, rev = reversed_for_upper(mat)
    sys_ = build_sts(mat_r, order_type="LS", sort_packs=False)
    assert sys_.lower.nnz == mat.nnz  # no entries flipped
    layout = LowerSolveLayout.build(sys_, b[rev][sys_.perm])
    x_sys = np.asarray(lower_solve(layout))
    x_r = np.zeros(mat.m, np.float32)
    x_r[sys_.perm] = x_sys
    x = x_r[rev]
    rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-5, rel


def test_upper_solve_cli(capsys):
    from hspmv.tools import sts as sts_cli

    rc = sts_cli.main([
        "synthetic:banded_1k", "--part", "upper", "--validate-only",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "Number Wrong: 0" in out
    assert "backward substitution" in out


def test_upper_solve_cli_distributed(capsys):
    """--part upper composes with --devices: the reversal happens before
    the system build, so the distributed block back-substitution solves
    the reversed (lower) system unchanged."""
    import jax
    import pytest

    from hspmv.tools import sts as sts_cli

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rc = sts_cli.main([
        "synthetic:banded_1k", "--part", "upper", "--devices", "4",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "Number Wrong: 0" in out
