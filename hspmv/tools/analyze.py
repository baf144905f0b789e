"""Format-overhead and load-balance analyzers.

Role-equivalents of the reference's offline analysis helpers:
  * calculate_overhead.m (helpers/calculate_overhead.m:5-35): bytes in
    memory per format (coo/csr/csr2/csr3) — extended with the device
    layouts (SELL slabs / rank-windowed slabs).
  * analyze_warp_nnz.m (helpers/analyze_warp_nnz.m:23-66): replays the
    kernel's work decomposition counting nnz per work unit to expose
    load imbalance — here per (8,128) sub-tile and per 128-row chunk.

Usage: python -m hspmv.tools.analyze matrix.csr [--k 3 --sizes 8 8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def format_overheads(mat, k: int = 3, sup_row_sizes=(8, 8)) -> dict:
    """Bytes in memory per representation (4-byte words like the
    reference: calculate_overhead.m:5-13)."""
    m, nnz = mat.m, mat.nnz
    out = {
        "coo": 3 * nnz * 4,
        "csr": (m + 1 + 2 * nnz) * 4,
    }
    # csr2 = (sr + m + 2 nnz) * 4 ; csr3 = (ssr + sr + m + 2 nnz) * 4 with
    # level sizes from the actual hierarchy.
    try:
        from hspmv.formats.csrk import CSRkMatrix

        if k >= 2:
            c2 = CSRkMatrix.build(mat, k=2, sup_row_sizes=sup_row_sizes[:1])
            out["csr2"] = (c2.maps[0].shape[0] + m + 2 * nnz) * 4
        if k >= 3:
            c3 = CSRkMatrix.build(mat, k=3, sup_row_sizes=sup_row_sizes[:2])
            out["csr3"] = (
                c3.maps[0].shape[0] + c3.maps[1].shape[0] + m + 2 * nnz
            ) * 4
    except Exception as e:  # singular structures; report what we can
        out["csrk_error"] = str(e)

    from hspmv.formats.sell import RankedSlabs, SellSlabs

    sell = SellSlabs.from_csr(mat)
    out["sell"] = sell.hbm_bytes
    out["sell_padding_ratio"] = sell.padding_ratio
    try:
        ranked = RankedSlabs.from_csr(mat)
        out["ranked"] = ranked.hbm_bytes
        out["ranked_rank_nb"] = ranked.rank_nb
        out["sell_max_nb"] = sell.max_nb
    except ValueError as e:
        out["ranked_error"] = str(e)
    # Round-3 formats: report when the structure admits them.
    try:
        from hspmv.formats.packed import PackedRanked

        pk = PackedRanked.from_csr(mat)
        out["packed"] = pk.hbm_bytes
        out["packed_padding_ratio"] = pk.padding_ratio
    except Exception as e:
        out["packed_error"] = str(e)
    try:
        from hspmv.formats.dia import DiaSlabs

        dl = DiaSlabs.from_csr(mat)
        out["dia"] = dl.hbm_bytes
        out["dia_num_diagonals"] = dl.num_diagonals
    except Exception as e:
        out["dia_error"] = str(e)
    return out


def load_balance(mat) -> dict:
    """Work distribution across the slab layout's units (the reference
    counts nnz and loop iterations per 4-super-row warp,
    analyze_warp_nnz.m:23-57)."""
    from hspmv.formats.sell import LANES, SUBLANES, SellSlabs

    sell = SellSlabs.from_csr(mat)
    vals = np.asarray(sell.vals)
    real = (vals != 0.0).reshape(sell.num_subtiles, SUBLANES * LANES)
    per_sub = real.sum(axis=1)
    per_chunk = np.bincount(
        np.asarray(sell.sub_chunk), weights=per_sub,
        minlength=sell.num_chunks,
    )[: sell.num_chunks]
    nb = np.asarray(sell.sub_nb)

    def spread(a):
        a = a.astype(np.float64)
        return {
            "min": float(a.min()) if a.size else 0.0,
            "max": float(a.max()) if a.size else 0.0,
            "avg": float(a.mean()) if a.size else 0.0,
            "cv": float(a.std() / max(a.mean(), 1e-30)) if a.size else 0.0,
        }

    return {
        "subtile_nnz": spread(per_sub),
        "chunk_nnz": spread(per_chunk),
        "subtile_gather_blocks": spread(nb),
        "num_subtiles": sell.num_subtiles,
        "padding_ratio": sell.padding_ratio,
    }


def dense_roofline(mat, device_kind: str = "NVIDIA H100 80GB HBM3") -> dict:
    """Dense-GEMV equivalent datum — the 'fourth vendor baseline' role.

    The reference reports MKL/cuSPARSE/hipSPARSE/Kokkos numbers per
    matrix; the natural extra baseline is the DENSE operator: a dense
    y = A x moves m*n*4 bytes of operator at device-memory rate (the
    arithmetic is never the bound at these aspect ratios), so its
    achievable effective-sparse rate is 2*nnz / (m*n*4 / BW), with BW
    the published peak of the modeled card (hspmv/hw.py).
    """
    from hspmv.hw import spec_for_kind

    bw = spec_for_kind(device_kind).hbm_bytes_per_s
    dense_bytes = mat.m * mat.n * 4
    dense_time = dense_bytes / bw
    return {
        "dense_operator_mb": dense_bytes / 2**20,
        "dense_time_s": dense_time,
        "dense_equiv_gflops": 2 * mat.nnz / dense_time / 1e9,
        "density": mat.nnz / max(mat.m * mat.n, 1),
    }


def main(argv=None):
    from hspmv.tools.stats import load

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--sizes", type=int, nargs="*", default=[8, 8])
    ap.add_argument("--device-kind", default="NVIDIA H100 80GB HBM3",
                    help="card whose published peak prices the dense "
                    "roofline (a row of hspmv/hw.py)")
    args = ap.parse_args(argv)

    mat = load(args.input)
    print("== format overheads (bytes)")
    for name, v in format_overheads(mat, args.k, tuple(args.sizes)).items():
        print(f"{name}: {v}")
    print("== kernel load balance")
    for name, v in load_balance(mat).items():
        print(f"{name}: {v}")
    print("== dense-GEMV equivalent (vendor-baseline datum)")
    for name, v in dense_roofline(mat, args.device_kind).items():
        print(f"{name}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
