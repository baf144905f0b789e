"""Multi-card scaling report: shard balance + interconnect traffic.

The reference has nothing distributed to compare against (SURVEY.md
§2.5); this reports what the sharded SpMV will move per call so
deployments can be sized before hardware is committed:

  * per-shard rows/nnz balance,
  * halo width the banded exchange needs (and whether it applies),
  * link bytes per device per SpMV: halo exchange (2 * halo * 4B) vs
    all-gather (n * (D-1)/D * 4B),
  * the weak-scaling traffic model: halo traffic is constant per device
    as D grows (bandwidth-limited scaling), all-gather grows with n.

The traffic report runs on the host (no devices needed); --weak also
executes the sharded SpMV on the process's own devices. Validation of
the distributed schedule lives in tests/test_dist.py.

Usage: python -m hspmv.tools.scaling matrix.csr --devices 8 [--rcm]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def report(mat, n_devices: int) -> dict:
    from hspmv.dist.sharding import _round_up
    from hspmv.formats.sell import LANES

    m, n = mat.shape
    rows_per_shard = _round_up(_round_up(m, n_devices) // n_devices, 8 * LANES)
    shard_nnz = []
    reach = 0
    for d in range(n_devices):
        r0 = min(d * rows_per_shard, m)
        r1 = min((d + 1) * rows_per_shard, m)
        shard_nnz.append(int(mat.indptr[r1] - mat.indptr[r0]))
        cs = mat.indices[mat.indptr[r0] : mat.indptr[r1]]
        if cs.size:
            reach = max(reach, int(r0 - cs.min()), int(int(cs.max()) + 1 - r1))
    halo_ok = reach <= rows_per_shard
    halo_rows = _round_up(max(reach, LANES), LANES) if halo_ok else 0
    halo_bytes = 2 * halo_rows * 4
    allgather_bytes = int(n * (n_devices - 1) / n_devices * 4)
    nnz_arr = np.asarray(shard_nnz, dtype=np.float64)
    return {
        "devices": n_devices,
        "rows_per_shard": rows_per_shard,
        "shard_nnz_min": int(nnz_arr.min()),
        "shard_nnz_max": int(nnz_arr.max()),
        "shard_nnz_imbalance": float(nnz_arr.max() / max(nnz_arr.mean(), 1)),
        "halo_applicable": halo_ok,
        "halo_rows": halo_rows,
        "link_bytes_per_dev_halo": halo_bytes,
        "link_bytes_per_dev_allgather": allgather_bytes,
        "halo_traffic_saving": (
            round(allgather_bytes / max(halo_bytes, 1), 1) if halo_ok else 1.0
        ),
    }


def weak_scaling(
    d_list,
    base_rows: int = 4096,
    band: int = 64,
    nnz_per_row: int = 8,
    execute: bool = True,
    spec=None,
) -> list:
    """Weak-scaling harness: problem size grows with the device count
    (m = D * base_rows), the per-device work stays constant, and the
    halo traffic per device must stay O(band) — NOT O(n). Executes the
    sharded rank-windowed SpMV on however many devices are available
    (virtual CPU mesh in tests; real cards when present) and validates
    against the serial oracle; emits the per-D efficiency table the
    >=70% weak-scaling target is judged on (BASELINE.md).

    The model charges each shard its slab bytes at the published HBM
    bandwidth and the exchange at the published per-direction link
    rate of `spec` (default: the running card's row in hspmv.hw).

    Returns a list of row dicts (also the CSV schema).
    """
    import jax

    from hspmv.bench.harness import device_bytes

    if spec is None:
        from hspmv.hw import device_spec

        spec = device_spec()

    from hspmv.bench.matrices import random_banded
    from hspmv.dist.sharding import (
        OverlapRanked, ShardedRanked, make_row_mesh, spmv_overlap,
        spmv_sharded,
    )
    from hspmv.reorder import rcm as rcm_fn

    rows = []
    for d in d_list:
        mat = random_banded(base_rows * d, band, nnz_per_row, seed=0)
        mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
        lay = ShardedRanked.build(mat, d)
        halo_bytes = 2 * lay.halo * 4
        exchange_bytes = halo_bytes if lay.halo else int(
            mat.n * (d - 1) / max(d, 1) * 4
        )
        # Per-shard bytes: its slab stack plus x window read and y write.
        shard_bytes = device_bytes(lay) / d + 4 * 3 * lay.rows_per_shard
        t_comp = shard_bytes / spec.hbm_bytes_per_s
        # Pairwise exchanges run concurrently over all-to-all links.
        t_comm = exchange_bytes / spec.link_bytes_per_s if d > 1 else 0.0
        # Overlap model (OverlapRanked): the exchange hides behind the
        # interior kernel; only the edge fraction of the compute waits.
        # Edge entries = cross-shard columns, counted directly (building
        # the full OverlapRanked here would waste layout work on rows
        # that never execute).
        t_plain = t_comp + t_comm
        t_over = t_plain
        if d > 1 and lay.halo:
            rps = lay.rows_per_shard
            row_of = np.repeat(
                np.arange(mat.m, dtype=np.int64), mat.row_lengths
            )
            edge_nnz = int(
                np.sum((mat.indices // rps) != (row_of // rps))
            )
            edge_frac = edge_nnz / max(mat.nnz, 1)
            t_over = (
                max(t_comp * (1 - edge_frac), t_comm) + t_comp * edge_frac
            )
        row = {
            "devices": d,
            "rows": mat.m,
            "nnz": mat.nnz,
            "halo_rows": lay.halo,
            "link_bytes_per_dev": exchange_bytes,
            "model_efficiency": t_comp / t_plain,
            "overlap_efficiency": t_comp / t_over,
            "executed": False,
            "num_wrong": "",
            "rel_l2": "",
        }
        if execute and len(jax.devices()) >= d:
            import jax.numpy as jnp
            from jax.sharding import NamedSharding, PartitionSpec as P

            mesh = make_row_mesh(jax.devices()[:d])
            axis = "rows"
            lp = lay.device_put(mesh, axis)
            x = np.random.default_rng(1).standard_normal(mat.n).astype(
                np.float32
            )
            xp = np.zeros(lp.padded_m, np.float32)
            xp[: mat.n] = x
            xj = jax.device_put(
                jnp.asarray(xp), NamedSharding(mesh, P(axis))
            )
            y = np.asarray(spmv_sharded(lp, xj, mesh, axis))[: mat.m]
            y_ref = mat.matvec(x)
            from hspmv.bench.harness import validate

            wrong, rel = validate(y, y_ref)
            if d > 1 and lay.halo:
                # The overlapped schedule must agree too (the weak-
                # scaling table is also its correctness record).
                olay = OverlapRanked.build(mat, d)
                op = olay.device_put(mesh, axis)
                y_o = np.asarray(spmv_overlap(op, xj, mesh, axis=axis))[
                    : mat.m
                ]
                wrong += validate(y_o, y_ref)[0]
            row.update(executed=True, num_wrong=wrong, rel_l2=f"{rel:.3g}")
        rows.append(row)
    return rows


def main(argv=None):
    from hspmv.tools.spmv import load_input

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default=None,
                    help="matrix file / synthetic:<name> (traffic report "
                    "mode); omit with --weak")
    ap.add_argument("--devices", type=int, nargs="*", default=[2, 4, 8, 16])
    ap.add_argument("--rcm", action="store_true",
                    help="apply RCM first (halo width depends on it)")
    ap.add_argument("--weak", action="store_true",
                    help="run the executable weak-scaling harness "
                    "(m = D * base-rows per step) instead of the static "
                    "traffic report")
    ap.add_argument("--base-rows", type=int, default=4096)
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--out", default=None, help="CSV output (weak mode)")
    args = ap.parse_args(argv)

    if args.weak:
        import csv as csvmod

        from hspmv.cache import enable_compile_cache

        enable_compile_cache()

        # Executes on the process's own devices; rows past the device
        # count report the model only.
        rows = weak_scaling(
            args.devices, base_rows=args.base_rows, band=args.band
        )
        for r in rows:
            print(
                f"D={r['devices']}: rows={r['rows']} "
                f"halo={r['halo_rows']} rows, "
                f"{r['link_bytes_per_dev']} B/dev per link, "
                f"model efficiency {100 * r['model_efficiency']:.1f}% "
                f"(overlapped {100 * r['overlap_efficiency']:.1f}%)"
                + (
                    f" | executed wrong={r['num_wrong']} rel={r['rel_l2']}"
                    if r["executed"] else " | not executed (devices)"
                )
            )
        if args.out:
            with open(args.out, "w", newline="") as f:
                w = csvmod.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
        worst = min(
            (r["model_efficiency"] for r in rows if r["devices"] > 1),
            default=1.0,
        )
        print(f"worst model efficiency: {100 * worst:.1f}% (target >= 70%)")
        return 0 if worst >= 0.70 else 1

    mat = load_input(args.input)
    if args.rcm:
        from hspmv.reorder import rcm

        mat = mat.permuted(rcm(mat.indptr, mat.indices))
    for d in args.devices:
        r = report(mat, d)
        print(
            f"D={r['devices']}: rows/shard {r['rows_per_shard']} "
            f"nnz imbalance {r['shard_nnz_imbalance']:.2f} | "
            + (
                f"halo {r['halo_rows']} rows -> "
                f"{r['link_bytes_per_dev_halo']} B/dev per link "
                f"({r['halo_traffic_saving']}x less than all-gather)"
                if r["halo_applicable"]
                else f"all-gather {r['link_bytes_per_dev_allgather']} B/dev "
                "(columns reach past neighbor shards)"
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
