"""Parameter/benchmark sweep runner — the run_scripts/ role.

Role-equivalent of the reference's Python runner family (run_epyc.py:
26-137, run_tuning.py, run_cuda_new.py): iterate kernels x matrices x
super-row sizes, benchmark each configuration, and append CSV rows.
The CSV is opened in append mode so interrupted sweeps resume
(run_epyc.py:31,74's "a+" convention).

Matrices are named from the synthetic suite OR given as file paths /
globs (.mtx/.mtx.gz/.csr/.csr2/.csr3) — the reference runners iterate
directories of converted SuiteSparse files (run_epyc.py:85-100), so the
sweep accepts the same file-based inputs end to end.

Usage:
  python -m hspmv.tools.sweep --out results.csv \
      --matrices lap2d_256 'data/rcm/*.csr' --kernels ranked segsum \
      --srs 8 16 32 64
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import sys
import traceback

import numpy as np

CSV_FIELDS = [
    "matrix", "kernel", "k", "srs", "rows", "nnz",
    "time_min", "time_max", "time_avg", "gflops", "gnnzs",
    "num_wrong", "rel_l2", "pad_ratio", "max_nb", "bin_blocks",
]


def _resolve_matrices(entries, suite: dict):
    """Yield (name, loader) pairs from suite names, file paths, globs."""
    import glob as globmod

    from hspmv.tools.stats import load

    for entry in entries:
        if entry in suite:
            yield entry, suite[entry]  # zero-arg factory, built lazily
            continue
        paths = sorted(globmod.glob(entry)) or [entry]
        for p in paths:
            pp = pathlib.Path(p)
            if not pp.exists():
                raise SystemExit(
                    f"matrix {entry!r}: not a suite name "
                    f"({', '.join(sorted(suite))}) and no such file"
                )
            # Path-qualified key: bare basenames collide when one sweep
            # covers e.g. norm/a.csr and rcm/a.csr, silently skipping
            # the second on resume (ADVICE r2).
            name = (
                f"{pp.parent.name}/{pp.name}" if pp.parent.name else pp.name
            )
            yield name, (lambda q=p: load(q))


def _done_keys(path: pathlib.Path) -> set:
    if not path.exists():
        return set()
    with open(path) as f:
        reader = csv.DictReader(f)
        if reader.fieldnames and list(reader.fieldnames) != CSV_FIELDS:
            raise SystemExit(
                f"{path}: existing CSV header {reader.fieldnames} does not "
                f"match the current schema {CSV_FIELDS}; resuming would "
                "append misaligned rows — use a new --out file"
            )
        return {
            (r["matrix"], r["kernel"], r["k"], r["srs"])
            for r in reader
        }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="sweep.csv")
    ap.add_argument("--scale", default="small", choices=("tiny", "small", "bench"))
    ap.add_argument("--matrices", nargs="*", default=None)
    ap.add_argument("--kernels", nargs="*", default=["sell", "segsum"])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--rcm", nargs="?", const="always", default="never",
                    choices=("always", "never", "auto"),
                    help="RCM-reorder each matrix before the CSR-k build "
                    "(k=1 + --rcm is the flagship SpMV configuration). "
                    "'auto' lets the planner decide per matrix "
                    "(plan_layout().needs_rcm — stencil classes stay in "
                    "natural order so the auto kernel can pick DIA, the "
                    "same tri-state as tools/spmv.py); bare --rcm = "
                    "always, matching the old boolean flag")
    ap.add_argument("--srs", nargs="*", type=int,
                    default=[8, 16, 24, 32, 48, 64, 96, 128],
                    help="super-row size grid (reference grid run_epyc.py:24)")
    ap.add_argument("--bin-blocks", type=int, default=-1,
                    help="column-bin width (x blocks) for MANUAL "
                    "ranked/packed/sell rows; -1 = plan default for "
                    "auto rows / 0 (aligned slots) for manual kernels")
    ap.add_argument("--val-dtype", default="f32", choices=("f32", "bf16"),
                    help="value storage dtype for the ranked/packed/"
                    "dia kernels (bf16 rows are keyed "
                    "'<kernel>+bf16' and validated against the "
                    "bf16-rounded operator)")
    args = ap.parse_args(argv)

    from hspmv.cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from hspmv.bench import matrices as M
    from hspmv.bench.harness import bench_spmv, validate
    from hspmv.formats.csrk import CSRkMatrix
    from hspmv.formats.sell import RankedSlabs, SellSlabs
    from hspmv.kernels.sell import spmv_ranked, spmv_sell
    from hspmv.kernels.segsum import SegsumLayout, spmv_segsum

    vdt = jnp.bfloat16 if args.val_dtype == "bf16" else None
    if vdt is not None:
        bad = set(args.kernels) - {"ranked", "packed", "dia"}
        if bad:
            raise SystemExit(
                f"--val-dtype bf16 supports ranked/packed/dia "
                f"sweep kernels, not {sorted(bad)}"
            )

    suite = M.suite_factories(args.scale)
    entries = args.matrices or list(suite)
    out = pathlib.Path(args.out)
    done = _done_keys(out)
    new_file = not out.exists()
    if jax.devices()[0].platform == "gpu":
        from hspmv.hw import card_label

        print(f"device: {card_label()}")
    failed = 0
    with open(out, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if new_file:
            writer.writeheader()
        for name, loader in _resolve_matrices(entries, suite):
            mat = loader()
            rcm_applied = args.rcm == "always"
            if args.rcm == "auto" and mat.m == mat.n:
                from hspmv.tune.model import plan_layout

                rcm_applied = plan_layout(mat).needs_rcm
                if not rcm_applied:
                    print(f"{name}: planner keeps natural order")
            if rcm_applied:
                from hspmv.reorder import rcm as rcm_fn

                mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
            x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
            # The validation oracle depends only on (matrix, dtype, x):
            # hoist it out of the kernel x srs grid (rounding re-copies
            # the full value array; matvec is O(nnz)).
            mat_v = mat if vdt is None else mat.rounded(vdt)
            y_ref_full = mat_v.matvec(x)
            for kernel in args.kernels:
                kname = kernel if vdt is None else f"{kernel}+bf16"
                for srs in args.srs:
                    key = (name, kname, str(args.k), str(srs))
                    key_fb = (
                        name, kname.replace("packed", "packed>ranked"),
                        str(args.k), str(srs),
                    )
                    if key in done or key_fb in done:
                        continue
                    kname_row = kname
                    try:
                        ck = CSRkMatrix.build(
                            mat, k=args.k,
                            sup_row_sizes=(srs,) * max(args.k - 1, 0),
                        )
                        xj = jnp.asarray(ck.set_x(x))
                        kern, bb = kernel, max(args.bin_blocks, 0)
                        mat_l, vperm = ck.matrix, ck.perm
                        if kern == "auto":
                            from hspmv.formats.sell import sigma_sort
                            from hspmv.tune.model import plan_layout

                            plan = plan_layout(ck.matrix, assume_rcm=rcm_applied)
                            if plan.sigma:
                                # Planner-recommended SELL-C-sigma row
                                # sort (rows only — x is unaffected,
                                # validation goes through vperm), then
                                # re-plan on the sorted structure; keep
                                # the sort only if the re-planned cost
                                # actually improved (sorting a uniform
                                # banded matrix can INCREASE binned fill
                                # by mixing distant rows into one chunk).
                                mat_s, sperm = sigma_sort(
                                    ck.matrix, plan.sigma
                                )
                                plan_s = plan_layout(mat_s, assume_rcm=rcm_applied)
                                if plan_s.est_cost < plan.est_cost:
                                    mat_l, plan = mat_s, plan_s
                                    vperm = ck.perm[sperm]
                            kern, bb = plan.kernel, plan.bin_blocks
                        if kern == "sell":
                            lay = SellSlabs.from_csr(mat_l, bin_blocks=bb)
                            fn = spmv_sell
                            pad, nb = lay.padding_ratio, lay.max_nb
                        elif kern == "ranked":
                            lay = RankedSlabs.from_csr(
                                mat_l, bin_blocks=bb, val_dtype=vdt
                            )
                            fn = spmv_ranked
                            pad, nb = lay.padding_ratio, lay.rank_nb
                        elif kern == "dia":
                            from hspmv.formats.dia import DiaSlabs
                            from hspmv.kernels.dia import spmv_dia

                            lay = DiaSlabs.from_csr(mat_l, val_dtype=vdt)
                            fn = spmv_dia
                            pad, nb = lay.padding_ratio, lay.num_diagonals
                        elif kern == "packed":
                            from hspmv.formats.packed import PackedRanked
                            from hspmv.kernels.packed import spmv_packed

                            try:
                                lay = PackedRanked.from_csr(
                                    mat_l, val_dtype=vdt,
                                    bin_blocks=max(bb, 0),
                                )
                                fn = spmv_packed
                            except ValueError:
                                # Packed-delta overflow (back-to-back
                                # slabs mixing distant chunks): the
                                # quantized ranked layout bins per
                                # chunk. Record the kernel that RAN,
                                # not the one requested (review r5):
                                # a 'packed' row must not carry ranked
                                # measurements.
                                kname_row = kname.replace(
                                    "packed", "packed>ranked"
                                )
                                lay = RankedSlabs.from_csr(
                                    mat_l, bin_blocks=bb, val_dtype=vdt
                                )
                                fn = spmv_ranked
                            pad, nb = lay.padding_ratio, lay.rank_nb
                        elif kern == "cusparse":
                            from hspmv.kernels.cusparse import (
                                CSRDevice, spmv_cusparse,
                            )

                            lay = CSRDevice.from_csr(mat_l)
                            fn = spmv_cusparse
                            pad, nb = 1.0, 0
                        elif kern == "dense":
                            from hspmv.kernels.dense import (
                                DenseLayout, spmv_dense,
                            )

                            lay = DenseLayout.from_csr(mat_l)
                            fn = spmv_dense
                            # pad = densification blow-up (the datum).
                            pad = mat.m * mat.n / max(mat.nnz, 1)
                            nb = 0
                        else:
                            lay = SegsumLayout.from_csr(mat_l)
                            fn = spmv_segsum
                            pad, nb = 1.0, 0
                        y = np.asarray(fn(lay, xj))
                        wrong, rel = validate(y, y_ref_full[vperm])
                        r = bench_spmv(fn, lay, xj)
                        row = {
                            "matrix": name, "kernel": kname_row,
                            "k": args.k,
                            "srs": srs, "rows": mat.m, "nnz": mat.nnz,
                            "time_min": f"{r.time_min:.6g}",
                            "time_max": f"{r.time_max:.6g}",
                            "time_avg": f"{r.time_avg:.6g}",
                            "gflops": f"{r.gflops:.4g}",
                            "gnnzs": f"{r.gnnzs:.4g}",
                            "num_wrong": wrong, "rel_l2": f"{rel:.3g}",
                            "pad_ratio": f"{pad:.3f}", "max_nb": nb,
                            "bin_blocks": bb,
                        }
                    except Exception:
                        # Keep sweeping the other cells; the exit status
                        # reports that this one failed.
                        traceback.print_exc()
                        failed += 1
                        continue
                    writer.writerow(row)
                    f.flush()
                    print(
                        f"{name} {kname} srs={srs}: {row['gflops']} GFLOP/s "
                        f"wrong={wrong}"
                    )
    if failed:
        print(f"{failed} sweep cell(s) failed", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
