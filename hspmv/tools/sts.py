"""Sparse-triangular-solve benchmark CLI.

Role-equivalent of the reference's (driver-disabled) STS path: build the
pack schedule, run the lower solve on device, validate against serial
forward substitution, print the reference timing keys (the reference
would have run CSRk_Graph::lowerSTS in the same warmup+timed protocol
as SpMV; disabled call site spmv-csrk/spmv.cpp:219-234).

Usage:
  python -m hspmv.tools.sts matrix.csr [num_runs] \
      [--order LS|COLOR] [--k 2|3|4] [--sizes 8 ...] [--synthetic NAME]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("num_runs", nargs="?", type=int, default=20)
    ap.add_argument("--order", default="LS", choices=("LS", "COLOR"))
    ap.add_argument("--part", default="lower", choices=("lower", "upper"),
                    help="triangle to solve; 'upper' runs the backward "
                    "substitution by reversing rows+columns (the upper "
                    "triangle becomes the lower of the reversed system; "
                    "net-new — the reference ships only lowerSTS)")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--sizes", type=int, nargs="*", default=None)
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--devices", type=int, default=1,
                    help=">1: distributed block back-substitution over a "
                    "row mesh (dist/sts.py) instead of the single-chip "
                    "solve")
    ap.add_argument("--validate-only", action="store_true",
                    help="skip the timed benchmark (CI / CPU runs)")
    args = ap.parse_args(argv)

    from hspmv.cache import enable_compile_cache

    enable_compile_cache()

    from hspmv.bench.harness import bench_spmv
    from hspmv.sts.host import build_sts, check_error, compute_b
    from hspmv.sts.solve import LowerSolveLayout, lower_solve
    from hspmv.tools.spmv import load_input

    mat = load_input(args.input)
    if args.part == "upper":
        from hspmv.sts.host import reversed_for_upper

        mat, _rev = reversed_for_upper(mat)
        print("upper solve: rows+columns reversed (backward substitution)")
    sizes = tuple(args.sizes) if args.sizes else tuple([32] * max(args.k - 2, 0))
    sys_ = build_sts(mat, order_type=args.order, k=args.k, sup_row_sizes=sizes)
    print(
        f"packs: {sys_.num_packs}  pack sizes: min {int(sys_.pack_sizes().min())} "
        f"max {int(sys_.pack_sizes().max())} avg {float(sys_.pack_sizes().mean()):.1f}"
    )

    b = compute_b(sys_.lower)  # x_exact = ones

    if args.devices > 1:
        import jax

        from hspmv.dist.sharding import make_row_mesh
        from hspmv.dist.sts import ShardedLowerSolve, sts_solve_sharded

        avail = len(jax.devices())
        if args.devices > avail:
            raise SystemExit(
                f"requested {args.devices} devices, only {avail} available"
            )
        mesh = make_row_mesh(jax.devices()[: args.devices])
        lay, pad_index = ShardedLowerSolve.build(sys_, b, args.devices)
        lp = lay.device_put(mesh)
        x_pad = np.asarray(sts_solve_sharded(lp, mesh))
        x = x_pad[pad_index]
        num_wrong = int(np.sum(np.abs(x - 1.0) > args.tol))
        print(f"devices={args.devices} rows/shard={lay.rows_per_shard}")
        print(f"Total Error: {check_error(x):g}")
        print(f"Number Wrong: {num_wrong}")
        # Distributed timing is meaningful on real chips only; the CLI
        # reports validation (the simulated mesh serializes devices).
        return 0 if num_wrong == 0 else 1

    layout = LowerSolveLayout.build(sys_, b)

    x = np.asarray(lower_solve(layout))
    print(f"steps: {layout.sched.num_steps} x {layout.sched.T} sub-tiles")
    num_wrong = int(np.sum(np.abs(x - 1.0) > args.tol))
    print(f"Total Error: {check_error(x):g}")
    print(f"Number Wrong: {num_wrong}")
    if args.validate_only:
        return 0 if num_wrong == 0 else 1

    from hspmv.hw import card_label

    res = bench_spmv(
        lambda lay, b_sc: lower_solve(lay, b_scale=b_sc),
        layout, layout.b_scale, runs=args.num_runs, nnz=sys_.lower.nnz,
    )
    print(f"device: {card_label()}")
    print(res.summary(), end="")
    print(f"per step: {res.time_min / max(layout.sched.num_steps, 1):.3g} s")
    return 0 if num_wrong == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
