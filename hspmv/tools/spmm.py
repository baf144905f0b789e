"""SpMM benchmark CLI — Y = A @ X with B right-hand sides.

Net-new vs the reference (its drivers are single-vector SpMV only;
SURVEY.md §2.2): multi-vector products are the serving-shaped workload,
where the slab traffic amortizes across columns. Mirrors the
tools/spmv.py driver protocol — load, RCM, build the rank-windowed
layout, run the timed product, print `TimeMin/TimeMax/TimeAvg` and
validate each column against the serial oracle (spmv-csrk/spmv.cpp:
168-211's keys and tolerance).

Usage:
  python -m hspmv.tools.spmm matrix.csr [num_runs] --batch 8 \
      [--kernel auto|ranked|packed] [--rcm auto|always|never]
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("num_runs", nargs="?", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8,
                    help="number of right-hand-side columns B")
    ap.add_argument(
        "--kernel", default="auto", choices=("auto", "ranked", "packed"),
        help="slab layout; auto follows the planner",
    )
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"))
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--val-dtype", default="f32", choices=("f32", "bf16"),
                    help="slab value storage dtype; bf16 halves the "
                    "per-column-amortized value traffic (validated against "
                    "the bf16-rounded operator)")
    ap.add_argument("--devices", type=int, default=1,
                    help=">1: row-shard A over a device mesh and run the "
                    "distributed SpMM (dist.spmv_sharded); 0 = all "
                    "available devices")
    ap.add_argument("--overlap", action="store_true",
                    help="with --devices: overlap the halo exchange "
                    "behind the main kernel (dist.OverlapRanked)")
    ap.add_argument("--validate-only", action="store_true")
    args = ap.parse_args(argv)

    from hspmv.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from hspmv.formats.sell import RankedSlabs
    from hspmv.kernels.sell import spmv_ranked
    from hspmv.tools.spmv import load_input
    from hspmv.tune.model import plan_layout

    mat = load_input(args.input)
    perm = None
    if args.rcm != "never" and mat.m == mat.n:
        apply_rcm = args.rcm == "always" or plan_layout(mat).needs_rcm
        if apply_rcm:
            from hspmv.reorder import rcm as rcm_fn

            perm = rcm_fn(mat.indptr, mat.indices)
            mat = mat.permuted(perm)
            print("RCM applied")

    B = args.batch
    vdt = jnp.bfloat16 if args.val_dtype == "bf16" else None
    if args.devices != 1:
        return _distributed(mat, args, B, vdt)
    plan = plan_layout(mat, assume_rcm=perm is not None)
    kernel = args.kernel
    if kernel == "auto":
        kernel = "packed" if plan.kernel == "packed" else "ranked"
        print(f"auto kernel: {kernel} ({plan.reason})")
    if kernel == "packed":
        from hspmv.formats.packed import PackedRanked
        from hspmv.kernels.packed import spmv_packed

        try:
            layout = PackedRanked.from_csr(
                mat, bin_blocks=max(plan.bin_blocks, 0), val_dtype=vdt
            )
            return _run_single(mat, args, B, vdt, spmv_packed, layout)
        except ValueError as e:
            # Packed-delta overflow: the quantized ranked layout bins
            # per chunk.
            print(f"packed layout unavailable ({e}); using ranked")
    try:
        layout = RankedSlabs.from_csr(
            mat, bin_blocks=plan.bin_blocks, val_dtype=vdt
        )
    except ValueError as e:
        raise SystemExit(
            f"ranked layout unavailable for this matrix ({e}); "
            "SpMM runs on the rank-windowed layouts only"
        )
    return _run_single(mat, args, B, vdt, spmv_ranked, layout)


def _run_single(mat, args, B, vdt, fn, layout):
    """Generate X, validate against the column-wise serial oracle,
    time, and report — shared by the ranked and packed paths."""
    import numpy as np
    import jax.numpy as jnp

    from hspmv.bench.harness import bench_spmv, roofline_nnzs, validate

    rng = np.random.default_rng(0)
    X = rng.standard_normal((mat.n, B)).astype(np.float32)
    Xj = jnp.asarray(X)
    Y = np.asarray(fn(layout, Xj))
    mat_v = mat
    if vdt is not None:
        mat_v = mat.rounded(jnp.bfloat16)
        print("(bf16 values: validated vs the bf16-rounded operator)")
    Y_ref = np.stack([mat_v.matvec(X[:, b]) for b in range(B)], axis=1)
    # Shared magnitude-aware tolerance (bench.harness.validate): a raw
    # |delta| > tol absolute count trips on fp32 summation noise for
    # large-|y| matrices.
    wrong, rel = validate(Y, Y_ref, tol=args.tol)
    if args.validate_only:
        print(f"Number Wrong: {wrong} ")
        print(f"RelL2: {rel:.3g}")
        return 0 if wrong == 0 else 1

    from hspmv.hw import card_label

    res = bench_spmv(
        fn, layout, Xj, runs=args.num_runs,
        nnz=mat.nnz * B,  # one SpMM moves nnz*B FMAs
    )
    print(f"device: {card_label()}")
    print(res.summary(), end="")
    # Per-nnz slab traffic amortizes over B columns; x/y traffic doesn't.
    bytes_per_val = layout.hbm_bytes / max(mat.nnz, 1) / B
    roof = roofline_nnzs(bytes_per_val)
    print(
        f"vals/s: {res.gnnzs * 1e9:.4g} "
        f"({100 * res.gnnzs * 1e9 / roof:.0f}% of roofline) B={B}"
    )
    print(f"Number Wrong: {wrong} ")
    print(f"RelL2: {rel:.3g}")
    return 0 if wrong == 0 else 1


def _distributed(mat, args, B, vdt):
    """Row-sharded SpMM over all/requested devices — the distributed
    serving path (dist.spmv_sharded / dist.spmv_overlap on (n, B) X), validated
    against the serial oracle like the single-chip mode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hspmv.bench.harness import bench_spmv, validate
    from hspmv.dist.sharding import (
        OverlapRanked, ShardedRanked, make_row_mesh, spmv_overlap,
        spmv_sharded,
    )

    avail = len(jax.devices())
    D = args.devices or avail
    if D > avail:
        raise SystemExit(f"requested {D} devices, only {avail} available")
    mesh = make_row_mesh(jax.devices()[:D])
    lay = None
    if args.overlap and D > 1:
        try:
            lay = OverlapRanked.build(mat, D, val_dtype=vdt)
            fn = functools.partial(spmv_overlap, mesh=mesh)
            print(f"overlap split: edge nnz = {lay.edge.nnz}")
        except ValueError as e:
            print(f"overlap unavailable ({e}); using spmv_sharded")
    if lay is None:
        lay = ShardedRanked.build(mat, D, val_dtype=vdt)
        fn = functools.partial(spmv_sharded, mesh=mesh)
    lay = lay.device_put(mesh)
    print(f"devices={D} halo={lay.halo} rows/shard={lay.padded_m // D}")

    X = np.random.default_rng(0).standard_normal((mat.n, B)).astype(
        np.float32
    )
    Xp = np.zeros((lay.padded_m, B), np.float32)
    Xp[: mat.n] = X
    Xj = jax.device_put(
        jnp.asarray(Xp), NamedSharding(mesh, P("rows"))
    )
    Y = np.asarray(fn(lay, Xj))[: mat.m]
    mat_v = mat if vdt is None else mat.rounded(vdt)
    if vdt is not None:
        print("(bf16 values: validated vs the bf16-rounded operator)")
    Y_ref = np.stack([mat_v.matvec(X[:, b]) for b in range(B)], axis=1)
    # Magnitude-aware count, same rationale as the single-chip path.
    wrong, rel = validate(Y, Y_ref, tol=args.tol)
    if not args.validate_only:
        res = bench_spmv(fn, lay, Xj, runs=args.num_runs, nnz=mat.nnz * B)
        print(res.summary(), end="")
        print(f"vals/s: {res.gnnzs * 1e9:.4g} B={B} D={D}")
    print(f"Number Wrong: {wrong} ")
    print(f"RelL2: {rel:.3g}")
    return 0 if wrong == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
