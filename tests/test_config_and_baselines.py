"""Config file parsing, cuSPARSE baseline parity, analyzers, kernel planner,
hardware table."""

import numpy as np
import jax.numpy as jnp
import pytest

from hspmv.bench.matrices import laplacian_2d, random_banded, random_general
from hspmv.config import RunConfig
from hspmv.kernels.cusparse import (
    CSRDevice, lowers_to_cusparse, spmv_cusparse, spmv_cusparse_reference,
)
from hspmv.tools.analyze import format_overheads, load_balance
from hspmv.tune.model import exact_rank_nb, plan_layout


def test_config_spmv_roundtrip(tmp_path):
    p = tmp_path / "configSpMV.txt"
    # The reference's format: kernelType coarsenType k supRowSizes...
    # (readConfigFile, spmv-csrk/csrk.cpp:15-54)
    p.write_text("SpMV HAND 3 8 16\n")
    cfg = RunConfig.parse_file(str(p))
    assert cfg.kernel_type == "SpMV"
    assert cfg.coarsen_type == "hand"
    assert cfg.k == 3
    assert cfg.sup_row_sizes == (8, 16)
    out = tmp_path / "out.txt"
    cfg.write_file(str(out))
    assert RunConfig.parse_file(str(out)) == cfg


def test_config_sts():
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "configSTS.txt")
        with open(p, "w") as f:
            f.write("STS COLOR HAND 3 32\n")
        cfg = RunConfig.parse_file(p)
        assert cfg.kernel_type == "STS"
        assert cfg.ordering_type == "COLOR"
        assert cfg.k == 3
        assert cfg.sup_row_sizes == (32,)


def test_config_env(monkeypatch):
    monkeypatch.setenv("HSPMV_KERNEL", "ranked")
    monkeypatch.setenv("HSPMV_SUP_ROW_SIZES", "8,16")
    cfg = RunConfig.from_env()
    assert cfg.kernel == "ranked"
    assert cfg.sup_row_sizes == (8, 16)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cusparse_matches_oracle(seed):
    """The vendor baseline's wrapper (CSR arrays, shapes, the portable
    implementation on the CPU) against the serial CSR oracle."""
    mat = random_banded(400, 30, 6, seed=seed)
    lay = CSRDevice.from_csr(mat)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(spmv_cusparse(lay, jnp.asarray(x)))
    y_ref = mat.matvec(x)
    assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) < 1e-6
    np.testing.assert_allclose(
        spmv_cusparse_reference(lay, x), y_ref, rtol=1e-5, atol=1e-5
    )


def test_cusparse_refuses_bf16_values():
    """A value type cuSPARSE cannot take must fail, never fall back."""
    mat = random_banded(200, 20, 6, seed=1)
    lay = CSRDevice.from_csr(mat)
    lay = CSRDevice(
        lay.data.astype(jnp.bfloat16), lay.indices, lay.indptr,
        lay.m, lay.n, lay.nnz,
    )
    with pytest.raises(TypeError):
        spmv_cusparse(lay, jnp.zeros(mat.n, jnp.float32))


@pytest.mark.gpu
def test_cusparse_lowering_on_gpu():
    """On the card the baseline must lower to a cuSPARSE call."""
    mat = random_banded(2000, 30, 6, seed=1)
    lay = CSRDevice.from_csr(mat)
    assert lowers_to_cusparse(lay, jnp.zeros(mat.n, jnp.float32))


def test_hw_table_h100_row():
    from hspmv.hw import spec_for_kind

    s = spec_for_kind("NVIDIA H100 80GB HBM3")
    assert s.hbm_bytes_per_s == 3.35e12
    assert s.hbm_bytes == 80 * 10**9
    assert s.l2_bytes == 50 * 2**20
    assert s.smem_per_block_bytes == 227 * 2**10
    assert s.link_bytes_per_s == 450e9
    assert s.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-40GB", "NVIDIA H100 PCIe", ""])
def test_hw_unknown_kind_raises(kind):
    from hspmv.hw import spec_for_kind

    with pytest.raises(ValueError):
        spec_for_kind(kind)


def test_hw_device_spec_raises_on_cpu():
    """The CPU backend has no table row: device_spec must not swallow
    that into a default."""
    from hspmv.hw import device_spec

    with pytest.raises(ValueError):
        device_spec()


def test_format_overheads_keys():
    mat = laplacian_2d(16)
    out = format_overheads(mat, k=3, sup_row_sizes=(4, 4))
    # Reference formulas (helpers/calculate_overhead.m:5-13).
    assert out["coo"] == 3 * mat.nnz * 4
    assert out["csr"] == (mat.m + 1 + 2 * mat.nnz) * 4
    assert out["csr2"] > out["csr"]
    assert out["csr3"] > out["csr2"]
    assert out["sell"] > 0


def test_load_balance_keys():
    mat = random_banded(600, 40, 8, seed=2)
    lb = load_balance(mat)
    assert lb["subtile_nnz"]["max"] >= lb["subtile_nnz"]["avg"]
    assert lb["num_subtiles"] > 0


def test_exact_rank_nb_banded_vs_general():
    banded = laplacian_2d(48)  # natural order: band = 48
    chunk_nb, rank_nb = exact_rank_nb(banded)
    assert rank_nb <= chunk_nb
    assert rank_nb <= 3  # k-th nonzeros cluster tightly on a stencil

    general = random_general(2000, 6, seed=3)
    _, rank_general = exact_rank_nb(general)
    assert rank_general > 3  # scattered pattern: no rank clustering


def test_plan_layout_kernel_choice():
    # Tiny 5-point stencil: constant diagonals pass the DIA gates.
    assert plan_layout(laplacian_2d(16)).kernel == "dia"
    # Wide-band STENCIL (natural order, band 2048): constant diagonals
    # -> the index-free DIA layout.
    stencil = laplacian_2d(8, 2048)
    plan = plan_layout(stencil, assume_rcm=True)
    assert plan.kernel == "dia", (plan.kernel, plan.reason)
    # Same band structure but offsets jittered per row: hundreds of
    # distinct diagonals (DIA inadmissible), yet the k-th nonzeros of
    # neighboring rows still cluster -> aligned rank windows win.
    import numpy as np

    from hspmv.formats.csr import CSRMatrix

    full = laplacian_2d(8, 2048)
    rng = np.random.default_rng(7)
    rows = np.repeat(
        np.arange(full.m, dtype=np.int64), full.row_lengths
    )
    jitter = rng.integers(-8, 9, full.nnz)
    cols = np.clip(full.indices.astype(np.int64) + jitter, 0, full.n - 1)
    broken = CSRMatrix.from_coo(
        rows, cols, np.ones(full.nnz, np.float32), full.shape
    )
    plan = plan_layout(broken, assume_rcm=True)
    # Window-relative columns (narrow index bytes) beat absolute ones.
    assert plan.kernel in ("ranked", "packed"), (plan.kernel, plan.reason)
    # Random-within-band and fully scattered: still a window-relative
    # slab layout, chosen by device bytes (the reason says so).
    wide_random = random_banded(300_000, 1500, 8, seed=1)
    plan = plan_layout(wide_random, assume_rcm=True)
    assert plan.kernel in ("ranked", "packed"), (plan.kernel, plan.reason)
    assert "fewest device bytes" in plan.reason
    # Fully scattered: slot spans past the 8-bit window deltas leave the
    # absolute-column layout or binned windows, whichever is smaller.
    scattered = random_general(300_000, 8, seed=2)
    plan = plan_layout(scattered, assume_rcm=True)
    assert plan.kernel in ("sell", "ranked", "packed"), plan.reason
    assert plan.kernel == "sell" or plan.bin_blocks > 0, plan.reason


def _slab_bytes(lay) -> int:
    cols = getattr(lay, "lcols", None)
    cols = lay.cols if cols is None else cols
    return lay.vals.size * lay.vals.dtype.itemsize + cols.size * cols.dtype.itemsize


@pytest.mark.parametrize("name", ["banded", "general", "powerlaw", "jittered"])
def test_plan_layout_fewest_bytes(name):
    """The planner's rule: the chosen slab layout, built for real, moves
    (nearly) the fewest device bytes among sell / ranked / packed. Small
    matrices are sampled whole, so the estimate is the layout itself up
    to the slab-row quantum."""
    from hspmv.bench.matrices import power_law
    from hspmv.formats.packed import PackedRanked
    from hspmv.formats.sell import RankedSlabs, SellSlabs

    mat = {
        "banded": lambda: random_banded(20_000, 300, 12, seed=1),
        "general": lambda: random_general(20_000, 8, seed=2),
        "powerlaw": lambda: power_law(20_000, 8, seed=3),
        "jittered": lambda: random_banded(20_000, 40, 16, seed=4),
    }[name]()
    plan = plan_layout(mat, assume_rcm=True)
    assert plan.kernel in ("sell", "ranked", "packed"), plan.reason
    built = {"sell": _slab_bytes(SellSlabs.from_csr(mat))}
    for kname, cls in (("ranked", RankedSlabs), ("packed", PackedRanked)):
        try:
            built[kname] = _slab_bytes(cls.from_csr(mat))
        except ValueError:
            pass
    cls = {"sell": SellSlabs, "ranked": RankedSlabs, "packed": PackedRanked}
    chosen = _slab_bytes(
        cls[plan.kernel].from_csr(mat, bin_blocks=plan.bin_blocks)
    )
    assert chosen <= 1.15 * min(built.values()), (plan.reason, chosen, built)
    assert plan.est_cost > 0


@pytest.mark.parametrize("span,expect", [(1, 1), (2, 1), (3, 2), (256, 2), (257, 4)])
def test_planner_local_column_bytes(span, expect):
    from hspmv.tune.model import _lcol_bytes, slab_bytes

    assert _lcol_bytes(span) == expect
    assert slab_bytes(8, expect) == 8 * 128 * (4 + expect)


def test_plan_layout_sigma_recommendation():
    """Skewed row lengths (power-law-ish) -> planner recommends the
    SELL-C-sigma row sort; uniform stencils -> no recommendation."""
    import numpy as np

    from hspmv.formats.csr import CSRMatrix

    assert plan_layout(laplacian_2d(64), assume_rcm=True).sigma == 0

    rng = np.random.default_rng(0)
    m = 20_000
    lens = np.minimum((rng.pareto(1.2, m) * 3 + 1).astype(np.int64), 400)
    rows = np.repeat(np.arange(m), lens)
    cols = np.minimum(rows + rng.integers(0, 200, rows.shape[0]), m - 1)
    vals = np.ones(rows.shape[0], np.float32)
    skewed = CSRMatrix.from_coo(rows, cols, vals, (m, m))
    plan = plan_layout(skewed, assume_rcm=True)
    assert plan.sigma > 0, (plan.sigma, plan.reason)


def test_clone_layout_and_device_bytes():
    """bench_spmv_cold depends on clones being REAL copies (distinct
    buffers, identical values) and on device_bytes covering the array
    leaves of every layout family."""
    import jax
    import numpy as np

    from hspmv.bench.harness import clone_layout, device_bytes
    from hspmv.bench.matrices import laplacian_2d
    from hspmv.formats.dia import DiaSlabs
    from hspmv.formats.packed import PackedRanked
    from hspmv.formats.sell import RankedSlabs

    mat = laplacian_2d(48)
    for lay in (
        RankedSlabs.from_csr(mat),
        PackedRanked.from_csr(mat),
        DiaSlabs.from_csr(mat),
    ):
        cl = clone_layout(lay)
        a = jax.tree_util.tree_leaves(lay)
        b = jax.tree_util.tree_leaves(cl)
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
            assert la is not lb
        assert device_bytes(lay) == device_bytes(cl) > 0
