"""SpMV benchmark CLI — the reference driver binaries' role.

Role-equivalent of every `spmv.exe inputfile num_runs [sizes...]`
benchmark binary (reference: spmv-csr/spmv.c:116-225, spmv-csrk/
spmv.cpp:97-244): load a matrix, build the requested format, run the
timed kernel, print TimeMin/TimeMax/TimeAvg and validate against the
serial oracle through the permutation (`Number Wrong`).

Timing follows the reference: warm-up calls, then num_runs calls each
ended by block_until_ready (hspmv/bench/harness.py). Every timed result
names the card and its power limit.

Usage:
  python -m hspmv.tools.spmv matrix.csr [num_runs] [srs [ssrs ...]] \
      [--kernel auto|sell|ranked|packed|dia|cusparse|segsum|dense] \
      [--k 1|2|3|4]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_input(spec: str):
    """Load a matrix from a file path or a `synthetic:<name>` spec."""
    if spec.startswith("synthetic:"):
        from hspmv.bench import matrices

        return matrices.make(spec.split(":", 1)[1])
    from hspmv.tools.stats import load

    return load(spec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".csr/.csr3/.mtx file, or synthetic:<name>")
    ap.add_argument("num_runs", nargs="?", type=int, default=20,
                    help="timed calls")
    ap.add_argument("sizes", nargs="*", type=int,
                    help="super-row sizes per level (k-1 of them)")
    ap.add_argument(
        "--kernel", default="auto",
        choices=("auto", "sell", "ranked", "segsum",
                 "cusparse", "dia", "packed", "dense"),
    )
    ap.add_argument("--k", type=int, default=None,
                    help="CSR-k depth; default 1 (plain) or len(sizes)+1")
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--rcm", default="auto", choices=("auto", "always", "never"),
                    help="apply RCM before the layout build; 'auto' follows "
                    "the planner's needs_rcm (inputs from tools/convert's "
                    "rcm/ directory are already reordered — use 'never')")
    ap.add_argument("--bin-blocks", type=int, default=-1,
                    help="column-bin width in 128-col x blocks for the "
                    "ranked layout (scattered-matrix mode); -1 = follow "
                    "the planner, 0 = cluster-aligned slots")
    ap.add_argument("--sigma", type=int, default=-1,
                    help="SELL-C-sigma window: sort rows by descending "
                    "length within windows of this many rows before the "
                    "layout build (cuts padding on skewed-degree matrices); "
                    "-1 = follow the planner, 0 = off")
    ap.add_argument("--val-dtype", default="f32", choices=("f32", "bf16"),
                    help="value storage dtype (ranked/packed/dia kernels). "
                    "bf16 halves the dominant value traffic of this "
                    "memory-bound kernel; validation then runs against the "
                    "bf16-rounded operator (exact), with drift vs the f32 "
                    "oracle (~2e-3 rel on random values; zero for "
                    "bf16-representable values, e.g. constant stencils) "
                    "reported for information")
    ap.add_argument("--cold", action="store_true",
                    help="time the operator-streaming regime: cycle "
                         "over enough distinct operator copies (>= 6x "
                         "the card's L2) that no call finds its "
                         "operator in cache")
    ap.add_argument("--validate-only", action="store_true",
                    help="skip the timed benchmark (CI / CPU runs)")
    ap.add_argument("--layout-cache", default=None,
                    help="path to a .npz layout artifact: loaded when it "
                    "exists, written after build otherwise (the reference's "
                    "precomputed-.csr3 role). sell/ranked/packed kernels; "
                    "the matrix must still be supplied for validation.")
    args = ap.parse_args(argv)

    from hspmv.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from hspmv.bench.harness import bench_spmv, roofline_nnzs, validate
    from hspmv.formats.csrk import CSRkMatrix
    from hspmv.formats.sell import RankedSlabs, SellSlabs
    from hspmv.kernels.sell import spmv_ranked, spmv_sell
    from hspmv.kernels.segsum import SegsumLayout, spmv_segsum
    from hspmv.tune.model import plan_layout

    mat = load_input(args.input)

    work = mat
    pre_perm = None
    if args.rcm != "never" and mat.m == mat.n:
        apply_rcm = args.rcm == "always"
        if args.rcm == "auto":
            apply_rcm = plan_layout(mat).needs_rcm
        if apply_rcm:
            from hspmv.reorder import rcm as rcm_fn

            pre_perm = rcm_fn(mat.indptr, mat.indices)
            work = mat.permuted(pre_perm)
            print("RCM applied (converter.m role)")

    k = args.k if args.k is not None else (len(args.sizes) + 1 if args.sizes else 1)
    sizes = tuple(args.sizes) if args.sizes else tuple([16] * (k - 1))
    ck = CSRkMatrix.build(work, k=k, sup_row_sizes=sizes)
    print(f"k={k} sizes={list(sizes)} rows={mat.m} nnz={mat.nnz}")
    # Column (x) permutation: pre-RCM composed with the CSR-k perm. The
    # sigma row sort below does not relabel columns, so x uses col_perm
    # while validation uses out_perm (rows).
    col_perm = ck.perm if pre_perm is None else pre_perm[ck.perm]
    out_perm = col_perm
    # One planner pass serves sigma, the auto kernel choice, and the
    # bin-width default (also under an explicit --kernel ranked).
    kernel = args.kernel
    bin_blocks = args.bin_blocks
    sigma = args.sigma
    plan = None
    if kernel == "auto" or sigma < 0 or (kernel == "ranked" and bin_blocks < 0):
        plan = plan_layout(ck.matrix, assume_rcm=(k > 1))
    if sigma < 0:
        # Planner-recommended sigma (>20% sub-tile cut on skewed rows).
        sigma = plan.sigma
        if sigma:
            print(f"planner recommends sigma={sigma}")
    if sigma:
        from hspmv.formats.sell import sigma_sort

        sorted_mat, sperm = sigma_sort(ck.matrix, sigma)
        # The sort changes chunk structure (slab heights, spans), so
        # kernel/bin-width choices made pre-sort can be stale (ADVICE
        # r2): re-plan on the sorted matrix — and keep the sort only if
        # the re-planned cost improved (a planner-recommended sigma can
        # still lose on the full matrix, e.g. uniform banded rows where
        # sorting mixes distant rows into one chunk).
        plan_s = (
            plan_layout(sorted_mat, assume_rcm=(k > 1))
            if plan is not None else None
        )
        forced = args.sigma >= 0  # user-given sigma always applies
        if forced or plan is None or plan_s.est_cost < plan.est_cost:
            ck = type(ck)(
                matrix=sorted_mat, perm=ck.perm, maps=ck.maps, k=ck.k,
                sup_row_sizes=ck.sup_row_sizes,
            )
            out_perm = out_perm[sperm]
            plan = plan_s if plan_s is not None else plan
            print(f"sigma={sigma} row sort applied")
        else:
            print(
                f"sigma={sigma} rejected after re-plan "
                f"({plan_s.est_cost:.0f} >= {plan.est_cost:.0f})"
            )

    if kernel == "auto":
        kernel = plan.kernel
        print(f"auto kernel: {kernel} ({plan.reason})")
    if bin_blocks < 0:
        bin_blocks = (
            plan.bin_blocks
            if (plan and kernel in ("ranked", "sell", "packed"))
            else 0
        )
        if bin_blocks:
            print(f"planner bin width: W={bin_blocks} blocks")

    import pathlib

    vdt = jnp.bfloat16 if args.val_dtype == "bf16" else None
    if vdt is not None and kernel not in ("ranked", "packed", "dia"):
        raise SystemExit(
            f"--val-dtype bf16 supports the ranked/packed/dia kernels, "
            f"not {kernel!r}"
        )

    def build_or_load(cls, builder=None):
        cache = args.layout_cache
        # f32 keeps the historical 3-int config so existing caches stay
        # valid; bf16 layouts get a distinct fingerprint. The marker
        # tracks the layout actually built: a sell FALLBACK stores f32
        # (SellSlabs has no val_dtype), so its cache must carry the f32
        # fingerprint a later f32 run can load.
        stores_bf16 = vdt is not None and cls is not SellSlabs
        cfg = (bin_blocks, sigma, k) + ((1,) if stores_bf16 else ())
        if cache and pathlib.Path(cache).exists():
            from hspmv.formats.sell import load_layout

            lay = load_layout(cache, matrix=ck.matrix, config=cfg)
            if type(lay) is not cls:
                raise SystemExit(
                    f"cached layout is {type(lay).__name__}, kernel wants "
                    f"{cls.__name__}"
                )
            print(f"loaded layout from {cache}")
            return lay
        if builder is not None:
            lay = builder()
        else:
            kw = {"val_dtype": vdt} if cls is RankedSlabs else {}
            lay = cls.from_csr(ck.matrix, bin_blocks=bin_blocks, **kw)
        if cache:
            lay.save(cache, matrix=ck.matrix, config=cfg)
            print(f"saved layout to {cache}")
        return lay

    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    xj = jnp.asarray(x[col_perm])
    if kernel == "sell":
        layout = build_or_load(SellSlabs)
        fn = spmv_sell
        bytes_per_nnz = layout.hbm_bytes / max(mat.nnz, 1)
    elif kernel == "ranked":
        try:
            layout = build_or_load(RankedSlabs)
            fn = spmv_ranked
        except ValueError as e:
            from hspmv.formats.sell import LayoutCacheMismatch

            if isinstance(e, LayoutCacheMismatch):
                # A stale cache must say "rebuild it", not silently
                # benchmark a different kernel.
                raise SystemExit(str(e))
            # Packed-delta range exceeded: fall back to the plain layout.
            print(f"ranked layout unavailable ({e}); falling back to sell")
            if vdt is not None:
                print("(sell fallback stores f32 values; bf16 not applied)")
            layout = build_or_load(SellSlabs)
            fn = spmv_sell
        bytes_per_nnz = layout.hbm_bytes / max(mat.nnz, 1)
    elif kernel == "dia":
        from hspmv.formats.dia import DiaSlabs
        from hspmv.kernels.dia import spmv_dia

        layout = DiaSlabs.from_csr(ck.matrix, val_dtype=vdt)
        fn = spmv_dia
        print(f"DIA: {layout.num_diagonals} diagonals, "
              f"fill {layout.padding_ratio:.2f}x")
        bytes_per_nnz = layout.hbm_bytes / max(mat.nnz, 1)
    elif kernel == "packed":
        from hspmv.formats.packed import PackedRanked
        from hspmv.kernels.packed import spmv_packed

        try:
            layout = build_or_load(
                PackedRanked,
                builder=lambda: PackedRanked.from_csr(
                    ck.matrix, val_dtype=vdt,
                    bin_blocks=max(bin_blocks, 0),
                ),
            )
            fn = spmv_packed
            print(f"packed mixed-height slabs: pad "
                  f"{layout.padding_ratio:.2f}x, rank {layout.rank_nb}"
                  + (f", W={bin_blocks} bins" if bin_blocks > 0 else ""))
        except ValueError as e:
            from hspmv.formats.sell import LayoutCacheMismatch

            if isinstance(e, LayoutCacheMismatch):
                raise SystemExit(str(e))
            # Packed-delta range exceeded (back-to-back slabs can mix
            # distant chunks into one sub-tile): fall back to the
            # quantized ranked layout, which bins per chunk.
            print(f"packed layout unavailable ({e}); falling back to "
                  "ranked")
            try:
                layout = build_or_load(RankedSlabs)
                fn = spmv_ranked
            except ValueError as e2:
                if isinstance(e2, LayoutCacheMismatch):
                    raise SystemExit(str(e2))
                print(f"ranked layout unavailable ({e2}); falling back "
                      "to sell")
                layout = build_or_load(SellSlabs)
                fn = spmv_sell
        bytes_per_nnz = layout.hbm_bytes / max(mat.nnz, 1)
    elif kernel == "dense":
        from hspmv.kernels.dense import DenseLayout, spmv_dense

        layout = DenseLayout.from_csr(ck.matrix)
        fn = spmv_dense
        print(f"dense baseline: operator {layout.a.size * 4 / 2**20:.1f} "
              f"MB, density {mat.nnz / max(mat.m * mat.n, 1):.2%}")
        bytes_per_nnz = layout.hbm_bytes / max(mat.nnz, 1)
    elif kernel == "cusparse":
        from hspmv.kernels.cusparse import CSRDevice, spmv_cusparse

        layout = CSRDevice.from_csr(ck.matrix)
        fn = spmv_cusparse
        bytes_per_nnz = layout.hbm_bytes / max(mat.nnz, 1)
    else:
        layout = SegsumLayout.from_csr(ck.matrix)
        fn = spmv_segsum
        bytes_per_nnz = 12.0

    y = np.asarray(fn(layout, xj))
    # bf16 applies to the layout ACTUALLY built: a fallback (sell) or a
    # cache load may store f32 despite --val-dtype, and an f32 result
    # must not be judged against the rounded operator.
    lay_vals = getattr(layout, "vals", None)
    bf16_active = lay_vals is not None and lay_vals.dtype == jnp.bfloat16
    if bf16_active:
        # The user opted into bf16-rounded value STORAGE; correctness of
        # the kernel is exactness against the rounded operator. Drift vs
        # the full-precision oracle is reported for information.
        mat_r = mat.rounded(jnp.bfloat16)
        wrong, rel = validate(y, mat_r.matvec(x)[out_perm], tol=args.tol)
        y_f32 = mat.matvec(x)[out_perm]
        drift = np.linalg.norm(y - y_f32) / max(np.linalg.norm(y_f32), 1e-30)
        print(f"(bf16 values: validated vs the bf16-rounded operator; "
              f"RelL2 vs the f32 oracle = {drift:.2e})")
    else:
        wrong, rel = validate(y, mat.matvec(x)[out_perm], tol=args.tol)
        if vdt is not None:
            print("(--val-dtype bf16 requested but the built layout "
                  "stores f32; validated vs the f32 oracle)")
    if args.validate_only:
        print(f"Number Wrong: {wrong} ")
        print(f"RelL2: {rel:.3g}")
        return 0 if wrong == 0 else 1

    from hspmv.hw import card_label, device_spec

    spec = device_spec()
    if args.cold:
        from hspmv.bench.harness import (
            bench_spmv_cold, clone_layout, device_bytes,
        )

        lbytes = device_bytes(layout)
        res = bench_spmv_cold(
            fn, lambda: clone_layout(layout), xj,
            nnz=mat.nnz, layout_bytes=lbytes, runs=args.num_runs,
        )
        print(f"cold regime: operator streamed from HBM "
              f"({lbytes / 2**20:.1f} MB/copy, K={res.copies} copies)")
        # Only the operator copies are forced through HBM; x and y are
        # the same buffers every call, so charge the layout bytes only.
        bytes_per_nnz = lbytes / max(mat.nnz, 1)
        s_avg = lbytes / res.time_avg
        print(f"operator stream: {s_avg / 1e9:.1f} GB/s avg "
              f"({100 * s_avg / spec.hbm_bytes_per_s:.0f}% of the "
              f"published HBM bandwidth)")
    else:
        res = bench_spmv(fn, layout, xj, runs=args.num_runs)
    print(f"device: {card_label()}")
    print(res.summary(), end="")
    roof = roofline_nnzs(bytes_per_nnz, spec.hbm_bytes_per_s)
    t_rep = res.time_avg if args.cold else res.time_min
    nnzs = mat.nnz / t_rep
    print(f"nnz/s: {nnzs:.4g} ({100 * nnzs / roof:.0f}% of the "
          f"bandwidth roofline at {bytes_per_nnz:.2f} B/nnz)")
    print(f"Number Wrong: {wrong} ")
    print(f"RelL2: {rel:.3g}")
    return 0 if wrong == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
