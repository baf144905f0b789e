"""Iterative-solver CLI: CG / Jacobi-PCG over the sharded SpMV.

Net-new vs the reference (its only SpMV consumer is the benchmark loop,
spmv-csrk/spmv.cpp:161-191): this drives the distributed layer the way
a deployment would — A x = b solved by fixed-iteration CG with the
matrix row-sharded over every available device, halo exchange between
cards, psum-reduced dot products — and validates the solution against the
serial residual on the host.

Usage:
  python -m hspmv.tools.solve matrix.csr [--iters 100] [--pcg] \
      [--devices N] [--rcm auto|always|never]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--pcg", action="store_true",
                    help="Jacobi (diagonal) preconditioning")
    ap.add_argument("--precond", default=None,
                    choices=("jacobi", "ic0", "ic0-bj"),
                    help="preconditioner: jacobi (= --pcg), ic0 "
                    "(incomplete Cholesky, M^-1 applied by two "
                    "triangular solves per iteration — level-scheduled "
                    "on one card, or EXACT block back-substitution "
                    "chains when --devices > 1), or ic0-bj "
                    "(block-Jacobi IC(0): one factor per shard, zero "
                    "communication per application, weaker as D grows)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shards; 0 = all available devices")
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"))
    ap.add_argument("--tol", type=float, default=1e-4,
                    help="RMS residual bound for exit status")
    ap.add_argument("--overlap", action="store_true",
                    help="use the communication/compute-overlapped "
                    "layout (OverlapRanked: the halo ppermute runs "
                    "behind the main kernel); falls back to the "
                    "exchange-then-compute path when the banded halo "
                    "does not apply")
    args = ap.parse_args(argv)

    from hspmv.cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hspmv.dist.sharding import ShardedRanked, make_row_mesh
    from hspmv.dist.solvers import cg_solve, pcg_solve
    from hspmv.tools.spmv import load_input
    from hspmv.tune.model import plan_layout

    mat = load_input(args.input)
    if mat.m != mat.n:
        raise SystemExit("CG needs a square (SPD) matrix")
    if args.rcm != "never":
        if args.rcm == "always" or plan_layout(mat).needs_rcm:
            from hspmv.reorder import rcm as rcm_fn

            mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
            print("RCM applied")

    if args.precond == "jacobi":
        args.pcg = True
    avail = len(jax.devices())
    D = args.devices or avail
    if D > avail:
        raise SystemExit(f"requested {D} devices, only {avail} available")

    if args.precond in ("ic0", "ic0-bj"):
        if args.overlap or args.pcg:
            print("(--overlap/--pcg do not apply to --precond ic0; "
                  "ignored)")
        b_host = np.ones(mat.m, np.float32)
        if args.precond == "ic0-bj" and D == 1:
            # One shard: the block IS the whole matrix — identical to
            # exact ic0; route there (simpler single-chip path).
            print("ic0-bj with --devices 1 == exact ic0; "
                  "using single-chip ic0 path")
            args.precond = "ic0"
        if D == 1:
            from hspmv.formats.sell import RankedSlabs
            from hspmv.sts.ic0 import IC0Preconditioner, pcg_ic0_solve

            lay1 = RankedSlabs.from_csr(mat)
            pre = IC0Preconditioner.build(mat)
            print(f"ic0: rows={pre.lay_l.m} breakdowns={pre.breakdowns}")
            t0 = time.perf_counter()
            sol, rz = pcg_ic0_solve(
                lay1, jnp.asarray(b_host), pre, iters=args.iters,
            )
            sol = np.asarray(sol)
        else:
            # Distributed: exact IC(0) via two block back-substitution
            # chains per iteration (sts/ic0.ShardedIC0Preconditioner).
            from hspmv.dist.sharding import (
                ShardedRanked as _SR, make_row_mesh as _mesh,
                shard_vector as _shard,
            )
            from hspmv.sts.ic0 import (
                ShardedIC0Preconditioner, pcg_ic0_sharded,
            )

            mesh_d = _mesh(jax.devices()[:D])
            lay_d = _SR.build(mat, D).device_put(mesh_d)
            if args.precond == "ic0-bj":
                from hspmv.sts.ic0 import BlockJacobiIC0Preconditioner

                pre = BlockJacobiIC0Preconditioner.build(
                    mat, D, lay_d.padded_m
                ).device_put(mesh_d)
                kind = "ic0-bj (block-Jacobi"
            else:
                pre = ShardedIC0Preconditioner.build(
                    mat, D, lay_d.padded_m
                ).device_put(mesh_d)
                kind = "ic0 (distributed"
            print(f"{kind}, D={D}): rows={mat.m} "
                  f"breakdowns={pre.breakdowns}")
            bp = np.zeros(lay_d.padded_m, np.float32)
            bp[: mat.m] = b_host
            t0 = time.perf_counter()
            sol, rz = pcg_ic0_sharded(
                lay_d, _shard(bp, mesh_d), pre, mesh_d, iters=args.iters,
            )
            sol = np.asarray(sol)[: mat.m]
        dt = time.perf_counter() - t0
        resid = float(
            np.linalg.norm(mat.matvec(sol) - b_host) / np.sqrt(mat.m)
        )
        print(f"iters={args.iters} rms_residual={resid:.3e} "
              f"device_rz={float(rz):.3e} wall={dt:.2f}s (incl. compile)")
        return 0 if resid < args.tol else 1

    mesh = make_row_mesh(jax.devices()[:D])
    lay = None
    if args.overlap and D > 1:
        from hspmv.dist.sharding import OverlapRanked

        try:
            lay = OverlapRanked.build(mat, D).device_put(mesh)
            print(f"overlap split: edge nnz = {lay.edge.nnz} "
                  f"({100 * lay.edge.nnz / max(mat.nnz, 1):.1f}% waits "
                  "on the exchange)")
        except ValueError as e:
            print(f"overlap unavailable ({e}); using spmv_sharded")
    if lay is None:
        lay = ShardedRanked.build(mat, D).device_put(mesh)
    print(f"devices={D} halo={lay.halo} rows/shard={lay.padded_m // D}")

    b_host = np.ones(mat.m, np.float32)  # x_exact-independent RHS
    b = np.zeros(lay.padded_m, np.float32)
    b[: mat.m] = b_host
    b = jax.device_put(jnp.asarray(b), NamedSharding(mesh, P("rows")))

    t0 = time.perf_counter()
    if args.pcg:
        diag = mat.diagonal()
        inv = np.zeros(lay.padded_m, np.float32)
        # Signed reciprocal (negative diagonals must invert, not clamp);
        # rows with no diagonal entry get identity preconditioning.
        inv[: mat.m] = np.where(
            diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 1.0
        )
        inv = jax.device_put(
            jnp.asarray(inv), NamedSharding(mesh, P("rows"))
        )
        sol, rz = pcg_solve(lay, b, mesh, inv, iters=args.iters)
    else:
        sol, rz = cg_solve(lay, b, mesh, iters=args.iters)
    sol = np.asarray(sol)[: mat.m]
    dt = time.perf_counter() - t0
    resid = float(np.linalg.norm(mat.matvec(sol) - b_host) / np.sqrt(mat.m))
    print(f"iters={args.iters} rms_residual={resid:.3e} "
          f"device_rz={float(rz):.3e} wall={dt:.2f}s (incl. compile)")
    return 0 if resid < args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
