"""Parameter models: density-based tuning.

Two families:

  * reference_gpu_params — the reference's published per-architecture
    density models for CSR-3 super(-super)-row sizes, kept for
    reformat-auto file compatibility and as priors
    (volta: cuda-spmv-csrk/cuda/spmv-auto-volta.cu:132-158,
     ampere: spmv-auto-ampere.cu:130-158,
     mi100: hip/spmv-auto-mi100.cu:132-133,
     legacy: helpers/csr3params.m:14-37).

  * plan_layout — picks the kernel and layout knobs from matrix
    structure. The SpMV is bound by device memory, so the first-order
    model is the bytes each candidate layout streams: DIA when the
    matrix is a few constant diagonals, else the slab layout with the
    fewest device bytes. The rule is not calibrated on a card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def reference_gpu_params(density: float, arch: str = "ampere") -> dict:
    """(ssrs, srs, vec, veclevel, blockDims) from the density d = nnz/m."""
    d = max(float(density), 1e-9)
    ln = math.log(d)

    def r(v):  # round-half-up like the reference's floor(x + 0.5)
        return int(math.floor(v + 0.5))

    if arch == "ampere":
        ssrs, srs = r(9.175 - 1.32 * ln), r(20.5 - 3.5 * ln)
        vec, veclevel, bx, by = False, 4, 8, 12
        if 8.0 < d <= 16.0:
            vec, srs = True, ssrs * 4
        elif 16.0 < d <= 32.0:
            vec, veclevel, by = True, 8, 8
            ssrs = r(ssrs * 2.5)
            srs = ssrs * 3
        elif 32.0 < d <= 64.0:
            vec, veclevel, by = True, 16, 4
            ssrs *= 2
            srs = ssrs * 2
        elif d > 64.0:
            vec, veclevel, by = True, 32, 2
            ssrs = r(ssrs * 2.7)
            srs = r(ssrs / 4)
    elif arch == "volta":
        ssrs, srs = r(8.89888 - 1.25 * ln), r(10.14618 - 1.5 * ln)
        vec, veclevel, bx, by = False, 4, 8, 12
        if 8.0 < d <= 16.0:
            vec = True
            ssrs = r(ssrs * 1.5)
            srs = ssrs * 2
        elif 16.0 < d <= 32.0:
            vec, veclevel, by = True, 8, 8
            ssrs *= 4
            srs = ssrs >> 1
        elif 32.0 < d <= 64.0:
            vec, veclevel, by = True, 16, 4
            ssrs *= 5
            srs = ssrs >> 1
        elif d > 64.0:
            vec, veclevel, by = True, 32, 2
            ssrs *= 5
            srs = ssrs >> 1
    elif arch == "mi100":
        ssrs, srs = r(8.489 - 1.15 * ln), r(10.711 - 1.607 * ln)
        vec, veclevel, bx, by = False, 4, 8, 12
    elif arch == "legacy":
        ssrs = r(3.333 + 20.0 / (d * max(ln, 1e-9)))
        srs = r(0.667 * ssrs + 2.667)
        vec, veclevel, bx, by = False, 4, 8, 12
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return {
        "ssrs": max(ssrs, 1),
        "srs": max(srs, 1),
        "vec": vec,
        "veclevel": veclevel,
        "block_dims": (bx, by),
    }


@dataclasses.dataclass
class LayoutPlan:
    kernel: str  # 'ranked' | 'sell' | 'packed' | 'dia'
    needs_rcm: bool
    est_max_nb: float  # per-chunk column span, in 128-column blocks
    est_rank_nb: float  # per-slot column span (window-relative layouts)
    reason: str
    bin_blocks: int = 0  # >0: column-binned slots of this many blocks
    est_cost: float = 0.0  # estimated device bytes of the chosen layout
    sigma: int = 0  # >0: SELL-C-sigma row-sort window worth applying


# Candidate column-bin widths (x blocks) for scattered matrices: narrow
# bins keep window-relative columns in one byte, wide ones cut fill.
_BIN_WIDTHS = (1, 2, 4, 8, 16, 32, 64)


def _lcol_bytes(span_blocks: float) -> int:
    """Bytes per stored window-relative column (formats/sell.py narrows
    to uint8 / int16 / int32 by the largest local column)."""
    top = span_blocks * 128
    return 1 if top <= 256 else 2 if top <= 2**15 else 4


def slab_bytes(slot_rows: float, col_bytes: int, val_bytes: int = 4) -> float:
    """Device bytes of slab storage: 128 lanes x (value + column)."""
    return slot_rows * 128 * (val_bytes + col_bytes)


def exact_rank_nb(mat, align: bool = True, slots=None) -> tuple[int, int]:
    """(chunk span, per-slot span) in x blocks, exact, O(nnz) NumPy.

    chunk span drives the plain SELL kernel's gather loop; per-slot span
    drives the rank-windowed kernel's. align=True measures the
    cluster-aligned slot assignment RankedSlabs actually builds
    (formats/sell._aligned_slots); False measures ordinal ranks.
    slots: precomputed (ranks, kc) from _aligned_slots, to avoid a
    duplicate clustering pass when the caller already built it.
    """
    from hspmv.formats.sell import LANES, _aligned_slots

    m = mat.m
    lens = mat.row_lengths.astype(np.int64)
    if mat.nnz == 0 or m == 0:
        return 1, 1
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    if align:
        ranks, kc_raw = slots if slots is not None else _aligned_slots(mat)
        maxlen = int(kc_raw.max())
    else:
        maxlen = int(lens.max())
        ranks = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
            mat.indptr[:-1].astype(np.int64), lens
        )
    blocks = mat.indices.astype(np.int64) >> 7
    chunks = rows // LANES
    nchunks = int(chunks.max()) + 1

    key = chunks * maxlen + ranks
    if nchunks * maxlen <= 8 * max(mat.nnz, 1):
        lo = np.full(nchunks * maxlen, np.iinfo(np.int64).max)
        hi = np.full(nchunks * maxlen, -1)
        np.minimum.at(lo, key, blocks)
        np.maximum.at(hi, key, blocks)
        used = hi >= 0
        rank_nb = int((hi[used] - lo[used]).max()) + 1 if used.any() else 1
    else:
        # Sparse path: one very long row on a multi-million-row matrix makes
        # nchunks*maxlen scratch dwarf nnz (ADVICE r1). Sort by key and take
        # per-group extrema via reduceat over group starts.
        order = np.argsort(key, kind="stable")
        kb = blocks[order]
        starts = np.flatnonzero(
            np.concatenate(([True], key[order][1:] != key[order][:-1]))
        )
        glo = np.minimum.reduceat(kb, starts)
        ghi = np.maximum.reduceat(kb, starts)
        rank_nb = int((ghi - glo).max()) + 1 if starts.size else 1

    clo = np.full(nchunks, np.iinfo(np.int64).max)
    chi = np.full(nchunks, -1)
    np.minimum.at(clo, chunks, blocks)
    np.maximum.at(chi, chunks, blocks)
    cused = chi >= 0
    chunk_nb = int((chi[cused] - clo[cused]).max()) + 1 if cused.any() else 1
    return chunk_nb, rank_nb


def _exact_chunk_nb(mat) -> int:
    """Max per-128-row-chunk column span in x blocks (O(nnz), vectorized)."""
    from hspmv.formats.sell import LANES

    if mat.nnz == 0 or mat.m == 0:
        return 1
    rows = np.repeat(
        np.arange(mat.m, dtype=np.int64), mat.row_lengths
    )
    chunks = rows // LANES
    blocks = mat.indices.astype(np.int64) >> 7
    nchunks = int(chunks.max()) + 1
    clo = np.full(nchunks, np.iinfo(np.int64).max)
    chi = np.full(nchunks, -1)
    np.minimum.at(clo, chunks, blocks)
    np.maximum.at(chi, chunks, blocks)
    used = chi >= 0
    return int((chi[used] - clo[used]).max()) + 1 if used.any() else 1


def _sample_chunks(mat, max_chunks: int = 256):
    """Row-sliced submatrix of evenly spaced 128-row chunks (columns kept).

    Slot assignment is independent per chunk, so per-chunk layout stats
    (slab heights, padding) measured on the sample extrapolate linearly;
    returns (submatrix, scale) with scale = total_chunks / sampled.
    """
    from hspmv.formats.sell import LANES

    m = mat.m
    num_chunks = max(-(-m // LANES), 1)
    if num_chunks <= max_chunks:
        return mat, 1.0
    from hspmv.formats.csr import CSRMatrix

    pick = np.unique(
        np.linspace(0, num_chunks - 1, max_chunks).astype(np.int64)
    )
    indptr = [np.zeros(1, np.int64)]
    indices, data = [], []
    total = 0
    ip = mat.indptr.astype(np.int64)
    for c in pick:
        r0, r1 = c * LANES, min((c + 1) * LANES, m)
        e0, e1 = int(ip[r0]), int(ip[r1])
        indptr.append(ip[r0 + 1 : r1 + 1] - e0 + total)
        indices.append(mat.indices[e0:e1])
        data.append(mat.data[e0:e1])
        total += e1 - e0
        if r1 - r0 < LANES:  # tail chunk: keep 128-row framing via pad rows
            indptr.append(np.full(LANES - (r1 - r0), total, np.int64))
    sub = CSRMatrix(
        np.concatenate(indptr).astype(np.int32),
        np.concatenate(indices),
        np.concatenate(data).astype(np.float32),
        (pick.shape[0] * LANES, mat.n),
    )
    return sub, num_chunks / pick.shape[0]


def _subtiles_from_kc(kc) -> int:
    from hspmv.formats.sell import SUBLANES

    kcq = np.maximum((kc + SUBLANES - 1) // SUBLANES, 1)
    return int(kcq.sum())


def plan_layout(mat, assume_rcm: bool = False, exact: bool = True) -> LayoutPlan:
    """Choose kernel + layout parameters from matrix structure.

    DIA when the diagonal profile passes its gates (few diagonals, low
    fill); otherwise the slab candidate — plain SELL, cluster-aligned
    rank windows, packed mixed heights, or column-binned windows at
    several widths — with the fewest device bytes. Slot counts are
    measured on a sample of chunks (<= 256) and scaled.

    mat: CSRMatrix (ideally already RCM'd; set assume_rcm if so).
    exact=False skips the probes and plans plain SELL.
    """
    from hspmv.formats.sell import (
        LANES, SUBLANES, _aligned_slots, _binned_slots,
    )

    m = mat.m
    bands = mat.row_bands()
    est_nb = (float(np.percentile(bands, 95)) + LANES) / LANES if m else 1.0
    est_rank = est_nb
    candidates = []  # (bytes, kernel, bin_blocks, reason)
    sampled = None
    dia = None
    if exact and mat.nnz:
        from hspmv.formats.dia import (
            DIA_MAX_DIAGS, DIA_MAX_FILL, diagonal_profile,
        )

        d_s, _ = diagonal_profile(mat, sample_rows=256)
        if d_s <= DIA_MAX_DIAGS:
            d_x, fill_x = diagonal_profile(mat)
            if d_x <= DIA_MAX_DIAGS and fill_x <= DIA_MAX_FILL:
                dia = (
                    float(d_x * m * 4 + 8 * m),
                    f"{d_x} constant diagonals, fill {fill_x:.2f}x — "
                    "index-free DIA",
                )
    if exact and mat.nnz and dia is None:
        est_nb = float(_exact_chunk_nb(mat))
        sampled, scale = _sample_chunks(mat)
        ali_slots = _aligned_slots(sampled)
        _, rank_nb = exact_rank_nb(sampled, slots=ali_slots)
        est_rank = float(rank_nb)
        lens = sampled.row_lengths.astype(np.int64)
        nch = max(-(-sampled.m // LANES), 1)
        lpad = np.zeros(nch * LANES, np.int64)
        lpad[: sampled.m] = lens
        kc_ord = lpad.reshape(nch, LANES).max(axis=1)

        def quantized(kc):
            return _subtiles_from_kc(kc) * SUBLANES * scale

        def packed_rows(kc):
            return -(-int(np.maximum(kc, 4).sum()) // SUBLANES) * SUBLANES * scale

        candidates.append((
            slab_bytes(quantized(kc_ord), 4), "sell", 0,
            f"absolute columns, chunk span {est_nb:.0f} blocks",
        ))
        # Window bases are stored as 8-bit deltas per sub-tile, so the
        # aligned layouts cannot hold slots spanning 256 blocks or more.
        if est_rank < 256:
            cb = _lcol_bytes(est_rank)
            candidates.append((
                slab_bytes(quantized(ali_slots[1]), cb), "ranked", 0,
                f"aligned rank windows, span {est_rank:.0f} blocks",
            ))
            candidates.append((
                slab_bytes(packed_rows(ali_slots[1]), cb), "packed", 0,
                f"packed mixed-height slabs, span {est_rank:.0f} blocks",
            ))
        for w in _BIN_WIDTHS:
            if w * LANES >= 2 * max(mat.n, 1):
                break
            try:
                _, kc_bin = _binned_slots(sampled, w)
            except ValueError:
                continue
            cb = _lcol_bytes(w)
            candidates.append((
                slab_bytes(quantized(kc_bin), cb), "ranked", w,
                f"column-binned rank windows, W={w} blocks",
            ))
            candidates.append((
                slab_bytes(packed_rows(kc_bin), cb), "packed", w,
                f"packed column-binned slabs, W={w} blocks",
            ))

    needs_rcm = not assume_rcm and est_nb > 8 and m > LANES
    sigma = 0
    if dia is not None:
        # Any symmetric permutation (RCM) or row sort (sigma) destroys
        # the constant-diagonal structure DIA was admitted on.
        cost, kernel, bin_blocks, reason = dia[0], "dia", 0, dia[1]
        needs_rcm = False
    elif candidates:
        cost, kernel, bin_blocks, reason = min(candidates, key=lambda c: c[0])
        reason += (
            f" — fewest device bytes ({cost / max(mat.nnz, 1):.1f} B/nnz;"
            " uncalibrated rule)"
        )
        # SELL-C-sigma recommendation (the reference's AVX-512 lt4/gt4
        # role, spmv-intrin.c:119-223): recommend the local row sort
        # when it cuts ordinal sub-tile count by >20% — it permutes rows
        # only within sigma-row windows, so band locality survives.
        from hspmv.formats.sell import sigma_sort

        nch = max(-(-sampled.m // LANES), 1)
        lpad = np.zeros(nch * LANES, np.int64)
        lpad[: sampled.m] = sampled.row_lengths
        s_now = _subtiles_from_kc(lpad.reshape(nch, LANES).max(axis=1))
        cand_sigma = 32 * LANES
        sorted_sub, _ = sigma_sort(sampled, cand_sigma)
        lpad[: sampled.m] = sorted_sub.row_lengths
        s_sorted = _subtiles_from_kc(lpad.reshape(nch, LANES).max(axis=1))
        if s_sorted < 0.8 * s_now:
            sigma = cand_sigma
    else:
        cost, kernel, bin_blocks, reason = 0.0, "sell", 0, (
            "no structural probe (estimate only): plain SELL"
        )

    return LayoutPlan(
        kernel=kernel,
        needs_rcm=needs_rcm,
        est_max_nb=est_nb,
        est_rank_nb=est_rank,
        reason=reason,
        bin_blocks=bin_blocks,
        est_cost=float(cost),
        sigma=sigma,
    )
