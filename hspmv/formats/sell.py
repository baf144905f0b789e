"""SELL-slab device layouts: the device realization of CSR-k.

The reference's CSR-k hierarchy (super-super-rows -> super-rows -> rows,
spmv-csrk/csrk.h:253-345) maps onto the device layout as:

  rows        -> 128 lanes (one row per lane within a chunk)
  super-rows  -> row chunks of 128 rows whose nonzeros are stored as
                 ELL-style slabs: slab[k, lane] = k-th nonzero of the
                 chunk's lane-th row, padded to the chunk's max row length
                 quantized to 8 slot rows (a SELL-C-sigma layout with
                 C=128, cf. Kreutzer et al., arXiv:1307.6209)
  sub-tile    -> an (8, 128) slab block: 8 nonzero slots for all 128
                 rows of one chunk; the unit of per-sublane metadata

SellSlabs stores absolute columns. RankedSlabs stores each slot's column
relative to a per-(sub-tile, sublane) window base, which after RCM is
narrow enough for uint8/int16 local columns — fewer index bytes for the
memory-bound product. The product itself (kernels/slab.py) gathers x at
the decoded absolute columns, multiplies, and sums each chunk's slots.
Padding slots carry val=0 and an in-range column so they are inert.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.csr import CSRMatrix

LANES = 128
SUBLANES = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _uniform_subtiles_per_chunk(sub_chunk, num_chunks: int) -> int:
    """q if every chunk owns exactly q sub-tiles (uniform slab heights;
    padding sub-tiles carry the sentinel id num_chunks and are
    excluded), else 0. Uniform
    layouts reduce partials with a reshape-sum instead of a segment-sum
    (and skip the reduction entirely at q=1)."""
    sc = np.asarray(sub_chunk)
    real = sc[sc < num_chunks]
    if real.size == 0 or real.size % max(num_chunks, 1):
        return 0
    q = real.size // num_chunks
    expect = np.repeat(np.arange(num_chunks), q)
    return q if np.array_equal(real, expect) else 0


def sigma_sort(mat: CSRMatrix, sigma: int = 32 * LANES) -> tuple:
    """SELL-C-sigma row sorting: within windows of `sigma` rows, order
    rows by descending length (stable), so chunks get uniform slab
    heights and padding collapses for skewed-degree matrices
    (Kreutzer et al., arXiv:1307.6209 — the reference stores this class
    plain and eats the imbalance, cf. stats.c's nnz-variance report).

    Windows are local so RCM band locality survives (a row moves at most
    sigma-1 positions). Returns (sorted_matrix, perm) with perm new->old;
    fold perm into the caller's global permutation for validation.
    """
    m = mat.m
    lens = mat.row_lengths
    perm = np.empty(m, dtype=np.int64)
    for w0 in range(0, m, sigma):
        w1 = min(w0 + sigma, m)
        order = np.argsort(-lens[w0:w1], kind="stable")
        perm[w0:w1] = w0 + order
    # Row permutation only (columns unchanged): rebuild CSR directly.
    new_lens = lens[perm].astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(new_lens, out=indptr[1:])
    starts = mat.indptr[perm].astype(np.int64)
    take = (
        np.arange(int(indptr[-1]), dtype=np.int64)
        - np.repeat(indptr[:-1], new_lens)
        + np.repeat(starts, new_lens)
    )
    out = CSRMatrix(
        indptr.astype(np.int32), mat.indices[take], mat.data[take], mat.shape
    )
    return out, perm


def _aligned_slots(mat: CSRMatrix, gap: int = LANES, cap_factor: float = 2.0):
    """Cluster-aligned slot assignment per 128-row chunk.

    Ordinal slot assignment (j-th nonzero -> slot j) misaligns ranks when
    row lengths vary: a boundary row missing its left stencil neighbor
    shifts every later entry one slot left, so one slot mixes columns
    from different band positions and the rank-windowed kernel's window
    widens to the full bandwidth.

    Instead, group each chunk's diagonal offsets (col - row) into
    clusters split at gaps > `gap`, give each cluster a contiguous slot
    range sized by the max per-row entry count in it, and place entries
    at cluster_base + within-cluster ordinal. Slots then hold columns
    from one narrow band position. Falls back to ordinal slots for
    chunks where cluster widths would exceed cap_factor * max_row_len
    (padding guard).

    Returns (slots, kc): per-nonzero slot index and per-chunk slab
    height (unquantized).
    """
    from hspmv.reorder import native

    if native.available():
        # The C++ core implements exactly these semantics (exact-parity
        # tested); the per-chunk Python loop below took ~38s at 4.2M
        # rows vs ~1s native.
        return native.aligned_slots(
            mat.indptr, mat.indices, gap=gap, cap_factor=cap_factor,
            lanes=LANES,
        )

    m = mat.m
    num_chunks = max(_round_up(m, LANES) // LANES, 1)
    indptr = mat.indptr.astype(np.int64)
    cols = mat.indices.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
    d = cols - rows
    ordinal = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
        indptr[:-1], mat.row_lengths
    )
    slots = ordinal.copy()
    kc = np.zeros(num_chunks, dtype=np.int64)

    for c in range(num_chunks):
        r0 = c * LANES
        r1 = min(r0 + LANES, m)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e0 == e1:
            kc[c] = 1
            continue
        dloc = d[e0:e1]
        maxlen = int((indptr[r0 + 1 : r1 + 1] - indptr[r0:r1]).max())
        order = np.argsort(dloc, kind="stable")
        ds = dloc[order]
        # Cluster boundaries at gaps > gap.
        newc = np.empty(ds.shape[0], dtype=bool)
        newc[0] = True
        np.greater(ds[1:] - ds[:-1], gap, out=newc[1:])
        coarse = np.cumsum(newc) - 1
        # Subdivide each cluster into 64-column bins so every slot's
        # column span stays <= 64: with 64-granular window bases a slot
        # then always fits ONE 128-lane gather window (RankedSlabs
        # rank_nb == 1) regardless of alignment.
        cmin = np.zeros(int(coarse[-1]) + 1, dtype=dloc.dtype)
        cmin[coarse[newc]] = ds[newc]
        bins = (ds - cmin[coarse]) >> 6
        newc |= np.concatenate(([False], bins[1:] != bins[:-1]))
        cluster_of_sorted = np.cumsum(newc) - 1
        ncl = int(cluster_of_sorted[-1]) + 1
        cluster = np.empty(ds.shape[0], dtype=np.int64)
        cluster[order] = cluster_of_sorted
        # Per-row, per-cluster ordinal (entries are column-sorted, so
        # same-cluster entries of one row are consecutive).
        rloc = rows[e0:e1] - r0
        key = rloc * ncl + cluster
        # within = ordinal among equal keys (keys are non-decreasing
        # within each row; rows are contiguous) -> reset counter on change.
        change = np.empty(key.shape[0], dtype=bool)
        change[0] = True
        np.not_equal(key[1:], key[:-1], out=change[1:])
        seg_start = np.maximum.accumulate(
            np.where(change, np.arange(key.shape[0]), 0)
        )
        within = np.arange(key.shape[0]) - seg_start
        # Cluster widths = max within + 1 per cluster.
        width = np.zeros(ncl, dtype=np.int64)
        np.maximum.at(width, cluster, within)
        width += 1
        total = int(width.sum())
        if total > max(cap_factor * maxlen, maxlen + SUBLANES):
            kc[c] = maxlen  # ordinal fallback for this chunk
            continue
        base = np.zeros(ncl, dtype=np.int64)
        np.cumsum(width[:-1], out=base[1:])
        slots[e0:e1] = base[cluster] + within
        kc[c] = total
    return slots, kc



def matrix_key(mat: CSRMatrix, config: tuple = ()) -> np.ndarray:
    """Cheap identity fingerprint (m, n, nnz, crc32 of structure+values,
    plus layout-config ints like bin_blocks).

    Stored inside layout cache files so a stale artifact from a different
    matrix (or different rcm/sigma/k/bin_blocks configuration) is
    rejected at load instead of silently benchmarked.
    """
    import zlib

    h = zlib.crc32(np.ascontiguousarray(mat.indptr).tobytes())
    h = zlib.crc32(np.ascontiguousarray(mat.indices).tobytes(), h)
    h = zlib.crc32(np.ascontiguousarray(mat.data).tobytes(), h)
    return np.asarray(
        [mat.m, mat.n, mat.nnz, h, *config], dtype=np.int64
    )



def _binned_slots(mat: CSRMatrix, bin_blocks: int):
    """Column-binned slot assignment: the scattered-matrix layout.

    Aligned slots (_aligned_slots) need band structure: for a scattered
    matrix every 64-column bin holds ~1 entry per chunk, the slot count
    explodes past the padding cap (the reference's CSR-k kernel is
    structure-agnostic, spmv-csrk/csrk.cpp:149-330, so the layouts must
    cover scattered structure too).

    Here each chunk's entries are grouped by fixed-width column bins of
    `bin_blocks` x-blocks (bin = col >> (7 + log2(bin_blocks))); a bin's
    slots hold only columns from that bin, so every slot's gather window
    spans <= bin_blocks blocks no matter how scattered the matrix is.
    The cost is fill padding (slots per bin = max entries per lane,
    Poisson for random structure); the gain is window-relative columns
    that fit one byte at W <= 2.

    Requires per-row ascending columns (CSRMatrix invariant). Returns
    (slots, kc) like _aligned_slots. Guarantees that within every
    quantized 8-slot sub-tile the bin spread keeps packed window deltas
    <= 255 blocks (RankedSlabs' SMEM packing), inserting empty slots at
    oversized jumps.
    """
    if bin_blocks < 1 or (bin_blocks & (bin_blocks - 1)):
        raise ValueError("bin_blocks must be a power of two >= 1")
    m = mat.m
    nnz = mat.nnz
    num_chunks = max(_round_up(m, LANES) // LANES, 1)
    shift = 7 + int(bin_blocks).bit_length() - 1
    nbins = (max(mat.n - 1, 0) >> shift) + 1
    if nnz == 0:
        return np.zeros(0, np.int64), np.ones(num_chunks, np.int64)

    from hspmv.reorder import native

    if native.available():
        # C++ core (exact-parity tested): the per-entry Python repair
        # loop below crawls on adversarial scattered chunks.
        return native.binned_slots(mat.indptr, mat.indices, bin_blocks)

    lens = mat.row_lengths.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    chunks = rows >> 7
    bins = mat.indices.astype(np.int64) >> shift

    # Per-(row, bin) ordinal: columns ascend within a row, so equal
    # (row, bin) entries are consecutive.
    change = np.empty(nnz, dtype=bool)
    change[0] = True
    change[1:] = (rows[1:] != rows[:-1]) | (bins[1:] != bins[:-1])
    seg_start = np.maximum.accumulate(np.where(change, np.arange(nnz), 0))
    within = np.arange(nnz) - seg_start

    # Width per (chunk, bin) = max per-lane entry count; bases by cumsum
    # within the chunk (bin-sorted). Sparse group-by: the dense
    # (num_chunks x nbins) table can dwarf nnz for wide matrices.
    wkey = chunks * nbins + bins
    uk, inv = np.unique(wkey, return_inverse=True)
    width = np.zeros(uk.shape[0], dtype=np.int64)
    np.maximum.at(width, inv, within + 1)
    cums = np.cumsum(width)
    gchunk = uk // nbins
    first = np.empty(uk.shape[0], dtype=bool)
    first[0] = True
    np.not_equal(gchunk[1:], gchunk[:-1], out=first[1:])
    chunk_start = np.maximum.accumulate(
        np.where(first, cums - width, 0)
    )
    base = cums - width - chunk_start  # exclusive prefix within chunk
    kc = np.zeros(num_chunks, dtype=np.int64)
    np.add.at(kc, gchunk, width)

    slots = base[inv] + within

    # Packed-delta guard: within each quantized 8-slot sub-tile the bin
    # spread must keep (bin_hi - bin_lo) * W + (W - 1) <= 255. Check per
    # chunk on the slot->bin map; offending chunks get empty slots
    # inserted so oversized jumps start a fresh sub-tile.
    gbin = uk - gchunk * nbins
    kc_off = np.zeros(num_chunks + 1, dtype=np.int64)
    np.cumsum(kc, out=kc_off[1:])
    slot_bin = np.repeat(gbin, width)  # concatenated per-chunk slot->bin
    limit_bins = max((255 - (bin_blocks - 1)) // bin_blocks, 0)

    # Prefilter: only chunks whose TOTAL bin span exceeds the limit can
    # violate (this must include single-sub-tile chunks — a sparse row
    # set with scattered columns packs distant bins into one 8-slot
    # group, the exact STS scattered-dependency shape).
    chunk_lo = np.full(num_chunks, np.iinfo(np.int64).max)
    chunk_hi = np.full(num_chunks, -1)
    np.minimum.at(chunk_lo, gchunk, gbin)
    np.maximum.at(chunk_hi, gchunk, gbin)
    suspects = np.flatnonzero(chunk_hi - chunk_lo > limit_bins)

    bad = np.zeros(num_chunks, dtype=bool)
    for c in suspects:
        sb = slot_bin[kc_off[c] : kc_off[c + 1]]
        k8 = (sb.shape[0] // 8) * 8
        if k8:
            g = sb[:k8].reshape(-1, 8)
            if int((g[:, 7] - g[:, 0]).max()) > limit_bins:
                bad[c] = True
        tail = sb[k8:]
        if tail.size and int(tail[-1] - tail[0]) > limit_bins:
            bad[c] = True
    if bad.any():
        remap = {}
        for c in np.flatnonzero(bad):
            sb = slot_bin[kc_off[c] : kc_off[c + 1]]
            new_idx = np.empty(sb.shape[0], dtype=np.int64)
            pos = 0
            start_bin = int(sb[0])
            for i in range(sb.shape[0]):
                if pos % 8 == 0:
                    start_bin = int(sb[i])
                elif int(sb[i]) - start_bin > limit_bins:
                    pos = _round_up(pos, 8)
                    start_bin = int(sb[i])
                new_idx[i] = pos
                pos += 1
            remap[c] = new_idx
            kc[c] = pos
        for c, new_idx in remap.items():
            sel = chunks == c
            slots[sel] = new_idx[slots[sel]]

    kc = np.maximum(kc, 1)
    return slots, kc


def _to_device(layout):
    """A layout with every host array committed to the default device."""
    return jax.tree_util.tree_map(jnp.asarray, layout)


def _save_layout(layout, path, matrix: CSRMatrix | None = None,
                 config: tuple = ()) -> None:
    """Persist a layout's device arrays + static config to .npz.

    The analog of the reference's precompute artifacts (.csr2/.csr3
    files written by reformat so benchmarks skip coarsening/RCM,
    reformat-csr-to-csr3/spmv-auto.cpp:30-65): layout builds are
    host-side preprocessing worth caching for repeated runs.
    """
    children, aux = layout.tree_flatten()
    arrays = {f"c{i}": np.asarray(a) for i, a in enumerate(children)}
    # npz cannot serialize bfloat16 (ml_dtypes): store as a uint16 view
    # and record which children to view back on load.
    bf16 = [i for i, a in arrays.items() if a.dtype == jnp.bfloat16]
    for i in bf16:
        arrays[i] = arrays[i].view(np.uint16)
    if bf16:
        arrays["__bf16__"] = np.asarray(
            [int(k[1:]) for k in bf16], dtype=np.int64
        )
    if matrix is not None:
        arrays["__mkey__"] = matrix_key(matrix, config)
    np.savez_compressed(
        path,
        __class__=type(layout).__name__,
        __aux__=np.asarray(aux, dtype=np.int64),
        **arrays,
    )


def group_windows(sub_base, hi_units, rank_nb0: int, group_plan=None,
                  group_plan_budget=None):
    """Greedily merge sublanes whose gather windows always coincide.

    sub_base / hi_units: (S, 8) lowest/highest x block touched by each
    sublane of each sub-tile. Returns (sub_base_grouped, grp_b0,
    group_code): sub_base rewritten to each sublane's GROUP minimum (all
    downstream window-relative metadata becomes group-relative), grp_b0
    the sub-tile-major (S*G,) absolute base per group, and group_code
    packing G<<32 plus 4 bits of group id per sublane. Merges never
    widen the paired-load read extent (see RankedSlabs docstring); with
    group_plan, the given partition is validated against
    group_plan_budget instead (the multi-shard shared-plan path).

    Used by both RankedSlabs (quantized slabs) and PackedRanked (mixed
    heights) — the grouping is a pure function of the window extents and
    never cares which chunk a sublane belongs to.
    """
    S = sub_base.shape[0]
    # Merges may not widen the read extent: paired loads round the
    # budget to 2 blocks, except rank-1 layouts (binned W=1) whose
    # single-row-load fast path must survive, so only exactly-coincident
    # windows merge there.
    target = 1 if rank_nb0 == 1 else 2 * max((rank_nb0 + 1) // 2, 1)
    if group_plan is not None:
        members = [list(mem) for mem in group_plan]
        covered = sorted(r for mem in members for r in mem)
        if covered != list(range(SUBLANES)):
            raise ValueError(
                f"group_plan {group_plan} is not a partition of "
                f"the {SUBLANES} sublanes"
            )
        budget = (
            group_plan_budget if group_plan_budget is not None else target
        )
        for mem in members:
            ext = int(
                (hi_units[:, mem].max(axis=1)
                 - sub_base[:, mem].min(axis=1)).max()
            )
            if ext >= budget:
                raise ValueError(
                    f"group_plan member {tuple(mem)} spans {ext + 1} "
                    f"blocks, past the {budget}-block read budget "
                    "for this shard"
                )
    else:
        med = np.median(
            sub_base - sub_base.min(axis=1, keepdims=True), axis=0
        )
        order = np.argsort(med, kind="stable")
        members = [[int(order[0])]]
        glo = sub_base[:, order[0]].copy()
        ghi = hi_units[:, order[0]].copy()
        for r in order[1:]:
            nlo = np.minimum(glo, sub_base[:, r])
            nhi = np.maximum(ghi, hi_units[:, r])
            if int((nhi - nlo).max()) < target:
                members[-1].append(int(r))
                glo, ghi = nlo, nhi
            else:
                members.append([int(r)])
                glo = sub_base[:, r].copy()
                ghi = hi_units[:, r].copy()
    G = len(members)
    # Even G == SUBLANES (no merge) keeps the grouped encoding: one
    # absolute base per sublane, no delta range limit.
    gb = np.empty_like(sub_base)
    gmat = np.empty((G, S), np.int64)
    group_code = G << 32
    for gi, mem in enumerate(members):
        gmin = sub_base[:, mem].min(axis=1)
        gmat[gi] = gmin
        for r in mem:
            gb[:, r] = gmin
            group_code |= gi << (4 * r)
    # Sub-tile-major (S, G): row s holds sub-tile s's G group bases.
    return gb, gmat.T.reshape(-1).astype(np.int32), group_code


class LayoutCacheMismatch(ValueError):
    """A cached layout artifact does not match the requested matrix or
    layout configuration. A distinct type so callers with build
    fallbacks (e.g. ranked -> sell in tools/spmv.py) can surface the
    'rebuild it' message instead of silently switching kernels."""


def load_layout(path, matrix: CSRMatrix | None = None, config: tuple = ()):
    """Load a layout saved by SellSlabs.save / RankedSlabs.save.

    When `matrix` is given, the cached fingerprint (if present) must
    match it (and the layout-config ints) exactly — a mismatch raises
    LayoutCacheMismatch instead of returning a layout built from some
    other matrix/config.
    """
    with np.load(path, allow_pickle=False) as z:
        clsname = str(z["__class__"])
        aux = tuple(int(v) for v in z["__aux__"])
        if matrix is not None and "__mkey__" in z:
            if not np.array_equal(z["__mkey__"], matrix_key(matrix, config)):
                raise LayoutCacheMismatch(
                    f"layout cache {path} was built from a different matrix "
                    "or layout configuration (rcm/sigma/k/bin_blocks); "
                    "rebuild it"
                )
        bf16 = set(
            int(v) for v in z["__bf16__"]
        ) if "__bf16__" in z else set()
        children = []
        i = 0
        while f"c{i}" in z:
            a = z[f"c{i}"]
            if i in bf16:
                a = a.view(np.dtype(jnp.bfloat16))
            children.append(jnp.asarray(a))
            i += 1
    classes = {"SellSlabs": SellSlabs, "RankedSlabs": RankedSlabs}
    if clsname == "PackedRanked":
        from hspmv.formats.packed import PackedRanked

        classes["PackedRanked"] = PackedRanked
    try:
        cls = classes[clsname]
    except KeyError:
        raise LayoutCacheMismatch(
            f"layout cache {path} holds a {clsname}, which this loader "
            "does not support; rebuild it"
        )
    if len(children) + len(aux) != len(dataclasses.fields(cls)):
        raise LayoutCacheMismatch(
            f"layout cache {path} was written by another version of the "
            "layout; rebuild it"
        )
    return cls.tree_unflatten(aux, children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SellSlabs:
    """Device arrays + sub-tile metadata of the SELL-slab layout."""

    vals: jax.Array  # (total_k, 128) float32 slab values
    cols: jax.Array  # (total_k, 128) int32 absolute column ids
    sub_b0: jax.Array  # (S,) int32 first x block (col//128) per sub-tile
    sub_nb: jax.Array  # (S,) int32 number of x blocks per sub-tile
    sub_chunk: jax.Array  # (S,) int32 owning row-chunk per sub-tile (sorted)
    m: int
    n: int
    nnz: int
    num_chunks: int
    max_nb: int  # worst-case gather span, for diagnostics/tuning
    chunk_q: int = 0  # uniform sub-tiles per chunk (0 = ragged)

    def tree_flatten(self):
        children = (self.vals, self.cols, self.sub_b0, self.sub_nb, self.sub_chunk)
        aux = (self.m, self.n, self.nnz, self.num_chunks, self.max_nb, self.chunk_q)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def num_subtiles(self) -> int:
        return int(self.sub_b0.shape[0])

    def save(self, path, matrix: CSRMatrix | None = None,
             config: tuple = ()) -> None:
        _save_layout(self, path, matrix, config)

    @property
    def padded_nnz(self) -> int:
        return int(self.vals.shape[0]) * LANES

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    @property
    def hbm_bytes(self) -> int:
        """Bytes streamed from HBM per SpMV (roofline denominator)."""
        return (
            self.vals.size * 4
            + self.cols.size * 4
            + 4 * (self.n + self.m)
            + self.num_subtiles * LANES * 4  # partials write+read amortized
        )

    @classmethod
    def from_csr(
        cls, mat: CSRMatrix, align: bool = False, bin_blocks: int = 0,
        on_host: bool = False,
    ) -> "SellSlabs":
        """Build the layout from a (preferably RCM'd) CSR matrix.

        align: cluster-aligned slot assignment (see _aligned_slots) —
        slightly more padding, much narrower per-sublane gather windows
        for stencil-like structures (used by RankedSlabs).
        bin_blocks > 0: column-binned slots (_binned_slots) for
        scattered matrices — overrides align.
        on_host: keep the arrays in host memory (NumPy) — the sharded
        layouts stack shards on the host and place each on its device.
        """
        host = cls._host_build(mat, align, bin_blocks)
        sub_nb = host["sub_nb"]
        layout = cls(
            vals=host["vals"],
            cols=host["cols"],
            sub_b0=host["sub_b0"].astype(np.int32),
            sub_nb=sub_nb.astype(np.int32),
            sub_chunk=host["sub_chunk"].astype(np.int32),
            m=host["m"],
            n=host["n"],
            nnz=mat.nnz,
            num_chunks=host["num_chunks"],
            max_nb=int(sub_nb.max()) if len(sub_nb) else 1,
            chunk_q=host["chunk_q"],
        )
        return layout if on_host else _to_device(layout)

    @staticmethod
    def _host_build(mat: CSRMatrix, align: bool, bin_blocks: int) -> dict:
        """Host/NumPy half of from_csr (no JAX calls)."""
        m, n = mat.shape
        num_chunks = max(_round_up(m, LANES) // LANES, 1)

        rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
        if bin_blocks:
            ranks, kc_raw = _binned_slots(mat, bin_blocks)
        elif align:
            ranks, kc_raw = _aligned_slots(mat)
        else:
            lens = np.zeros(num_chunks * LANES, dtype=np.int64)
            lens[:m] = mat.row_lengths
            kc_raw = lens.reshape(num_chunks, LANES).max(axis=1)
            ranks = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
                mat.indptr[:-1].astype(np.int64), mat.row_lengths
            )

        # Per-chunk slab height, quantized to 8 slot rows (one sub-tile), at
        # least one sub-tile per chunk.
        kc = np.maximum(
            (kc_raw + SUBLANES - 1) // SUBLANES * SUBLANES, SUBLANES
        )
        koff = np.zeros(num_chunks + 1, dtype=np.int64)
        np.cumsum(kc, out=koff[1:])
        total_k = int(koff[-1])

        vals = np.zeros((total_k, LANES), dtype=np.float32)
        # int32: column ids fit (n < 2^31) and the padded array is the
        # build's dominant memory traffic (pad x nnz x 128 lanes) — at
        # an 80x power-law fill int64 temporaries alone cost minutes.
        cols = np.full((total_k, LANES), -1, dtype=np.int32)

        # Scatter nonzeros: the j-th nonzero of row r lands at
        # (koff[chunk(r)] + slot(j), lane(r)); slot = ordinal rank, or the
        # cluster-aligned/binned slot.
        from hspmv.reorder import native

        if not align and not bin_blocks and native.available():
            dest_k, dest_l = native.sell_targets(mat.indptr, koff, LANES)
        else:
            dest_k = koff[rows // LANES] + ranks
            dest_l = rows % LANES
        vals[dest_k, dest_l] = mat.data
        cols[dest_k, dest_l] = mat.indices

        # Per-sub-tile x block range [b0, b0+nb), padding excluded.
        # Reduced over the nnz ENTRIES (ufunc.at), not the padded array:
        # at a power-law 80x fill the padded scans cost minutes while the
        # entry reductions are O(nnz).
        num_subtiles = total_k // SUBLANES
        sub_of = dest_k // SUBLANES
        sub_min = np.full(num_subtiles, np.iinfo(np.int32).max, np.int64)
        np.minimum.at(sub_min, sub_of, mat.indices)
        sub_min[sub_min == np.iinfo(np.int32).max] = 0  # all-pad sub-tiles
        sub_b0 = sub_min // LANES
        sub_bmax = np.zeros(num_subtiles, np.int64)
        np.maximum.at(sub_bmax, sub_of, mat.indices)
        sub_bmax //= LANES
        sub_nb = np.maximum(sub_bmax - sub_b0 + 1, 1)

        # Padding slots reuse the sub-tile's first block so the gather loop
        # already covers them; val=0 keeps them inert.
        pad_fill = np.broadcast_to(
            (sub_b0 * LANES).repeat(SUBLANES)[:, None], (total_k, LANES)
        )
        np.copyto(cols, pad_fill, where=(cols == -1))

        # Owning chunk per sub-tile (sorted).
        sub_chunk = np.repeat(
            np.arange(num_chunks, dtype=np.int64), kc // SUBLANES
        )

        return dict(
            vals=vals, cols=cols, sub_b0=sub_b0, sub_nb=sub_nb,
            sub_chunk=sub_chunk, m=m, n=n, num_chunks=num_chunks,
            chunk_q=_uniform_subtiles_per_chunk(sub_chunk, num_chunks),
            # Host-only extras (not part of the device layout): entry
            # destinations, for consumers that derive per-sublane stats
            # in O(nnz) instead of scanning the padded arrays.
            dest_k=dest_k,
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RankedSlabs:
    """Rank-windowed SELL layout: per-SUBLANE gather windows.

    A whole (8,128) sub-tile of a banded matrix spans the full RCM
    bandwidth (entries of one row sit at both band edges), e.g. 17
    blocks of 128 columns on a 1024x1024 grid Laplacian. But the k-th
    nonzeros (columns sorted within each row) of 128 consecutive rows
    cluster into ~2 blocks, so a column stored relative to its
    sublane's window base fits uint8 (span <= 2 blocks) or int16.

    A slot's column span is bounded by the 128-row drift within its
    chunk plus the 64-wide offset bin (_aligned_slots): at most 3 and
    typically 2 blocks.

    Storage:
      vals      (total_k, 128) float32, identical to SellSlabs
      lcols     (total_k, 128) uint8/int16/int32 LOCAL column =
                col - 128*base of the owning sublane's window
      sub_b0    (S,) int32 min window base over the sub-tile's sublanes
      sub_dlo/hi (S,) int32: per-sublane base deltas from sub_b0, four
                8-bit fields each (sublanes 0-3 in dlo, 4-7 in dhi)
      sub_chunk (S,) as in SellSlabs
      rank_nb   widest window, in blocks (max lcol >> 7, + 1)
    """

    vals: jax.Array
    lcols: jax.Array
    sub_b0: jax.Array
    sub_dlo: jax.Array
    sub_dhi: jax.Array
    sub_chunk: jax.Array
    m: int
    n: int
    nnz: int
    num_chunks: int
    rank_nb: int
    chunk_q: int = 0  # uniform sub-tiles per chunk (0 = ragged)
    # Grouped windows: sublanes whose windows coincide share ONE base,
    # stored ABSOLUTE in grp_b0 ((S*G,) int32, sub-tile-major) instead
    # of the packed deltas. group_code packs the static sublane->group
    # map, 4 bits per sublane (0 = grouping disabled).
    grp_b0: jax.Array = None
    group_code: int = 0

    def tree_flatten(self):
        children = (
            self.vals, self.lcols, self.sub_b0, self.sub_dlo, self.sub_dhi,
            self.sub_chunk, self.grp_b0,
        )
        aux = (
            self.m, self.n, self.nnz, self.num_chunks, self.rank_nb,
            self.chunk_q, self.group_code,
        )
        return children, aux

    @property
    def groups(self) -> tuple:
        """Static sublane->group map decoded from group_code."""
        return tuple((self.group_code >> (4 * r)) & 15 for r in range(SUBLANES))

    @classmethod
    def tree_unflatten(cls, aux, children):
        # grp_b0 is the last CHILD but a defaulted (hence trailing)
        # dataclass field; map explicitly rather than positionally.
        return cls(*children[:6], *aux[:6], grp_b0=children[6],
                   group_code=aux[6])

    @property
    def num_subtiles(self) -> int:
        return int(self.sub_b0.shape[0])

    def save(self, path, matrix: CSRMatrix | None = None,
             config: tuple = ()) -> None:
        _save_layout(self, path, matrix, config)

    @property
    def padded_nnz(self) -> int:
        return int(self.vals.shape[0]) * LANES

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    @property
    def hbm_bytes(self) -> int:
        return (
            self.vals.size * self.vals.dtype.itemsize
            + self.lcols.size * self.lcols.dtype.itemsize
            + 4 * (self.n + self.m)
            + self.num_subtiles * LANES * 4
        )

    @property
    def group_members(self) -> tuple:
        """Group partition as member tuples ((sublanes of g0), ...) —
        the `group_plan` format from_csr accepts, so one layout's
        partition can be applied to sibling shard layouts."""
        g = self.groups
        G = max(g) + 1
        return tuple(
            tuple(r for r in range(SUBLANES) if g[r] == gi) for gi in range(G)
        )

    @classmethod
    def from_csr(
        cls, mat: CSRMatrix, align: bool = True,
        bin_blocks: int = 0, allow_groups: bool = True,
        group_plan: tuple | None = None,
        group_plan_budget: int | None = None,
        val_dtype=None, on_host: bool = False,
    ) -> "RankedSlabs":
        """val_dtype: slab value storage dtype (default float32).
        jnp.bfloat16 halves the dominant value traffic on this
        memory-bound kernel (the kernel widens to f32 on load, so only
        STORAGE is rounded). The kernel stays bit-faithful to the
        bf16-ROUNDED operator; vs the f32 oracle y drifts by the value
        rounding (~2e-3 relative L2 on random values — validate against
        round(A) for exact checks). Matrices whose values are
        bf16-representable, e.g. constant stencils, lose nothing.

        group_plan: an externally fixed group partition (tuple of
        sublane-member tuples) applied instead of the greedy merge —
        used by dist.ShardedRanked so every shard runs the SAME static
        grouped kernel; raises ValueError when this matrix's windows
        cannot honor the plan within the read-extent budget.
        group_plan_budget: read-extent budget (x blocks) to validate the
        plan against — the PLANNING shard's paired-load budget, which may
        exceed this shard's own (the stacked kernel runs at the global
        rank_nb, so a tail shard with a locally narrower rank must not
        reject the shared plan).
        on_host: keep the arrays in host memory, as SellSlabs.from_csr."""
        host = SellSlabs._host_build(mat, align, bin_blocks)
        cols = host["cols"]  # absolute, padding pre-filled in-window
        vals = host["vals"]
        dest_k = host.pop("dest_k")
        total_k = cols.shape[0]
        S = total_k // SUBLANES

        # Per-(sub-tile, sublane) window base (x blocks) over REAL
        # entries only (padding slots were filled with the sub-tile's
        # min block, which may be far from this sublane's cluster).
        # Reduced over the nnz ENTRIES — dest_k IS the flat (sub-tile,
        # sublane) id — because padded-array scans cost minutes at a
        # power-law 80x fill.
        SENT = np.iinfo(np.int32).max
        units_e = mat.indices.astype(np.int64) >> 7
        flat_lo = np.full(total_k, SENT, np.int64)
        np.minimum.at(flat_lo, dest_k, units_e)
        flat_hi = np.full(total_k, -1, np.int64)
        np.maximum.at(flat_hi, dest_k, units_e)
        sub_base = flat_lo.reshape(S, SUBLANES)
        empty = sub_base == SENT
        # Empty sublanes inherit the sub-tile's minimum real base (keeps
        # packed deltas small); all-empty sub-tiles fall back to unit 0.
        tile_min = sub_base.min(axis=1)
        tile_min[tile_min == SENT] = 0
        sub_base = np.where(empty, tile_min[:, None], sub_base)

        # Grouped windows: greedily merge sublanes whose windows always
        # coincide (a stencil's middle ranks share one cluster), storing
        # one ABSOLUTE base per group (G words per sub-tile instead of the
        # packed deltas). Merges never widen a group's window past the
        # original read extent, so local columns keep their width.
        group_code = 0
        grp_b0 = np.zeros(0, np.int32)
        want_groups = (allow_groups or group_plan is not None) and S
        if want_groups:
            hi_units = flat_hi.reshape(S, SUBLANES)
            hi_units = np.where(hi_units < 0, sub_base, hi_units)
            rank_nb0 = int((hi_units - sub_base).max()) + 1
            sub_base, grp_b0, group_code = group_windows(
                sub_base, hi_units, rank_nb0,
                group_plan=group_plan, group_plan_budget=group_plan_budget,
            )

        # Local columns; padding slots point at the sublane window's
        # first entry (val=0 keeps them inert). In-place on the cols
        # buffer (no longer needed in absolute form): the padded array
        # is the dominant allocation, so avoid broadcast temporaries.
        real3 = (vals != 0.0).reshape(S, SUBLANES, LANES)
        c3 = cols.reshape(S, SUBLANES, LANES)
        c3 -= (sub_base[:, :, None] << 7).astype(cols.dtype)
        np.copyto(c3, 0, where=~real3)
        lcols = cols
        rank_nb = (int(lcols.max()) >> 7) + 1 if S else 1
        if S and int(lcols.min()) < 0:
            # Negative local columns mean a window base above its own
            # entries — silent out-of-window gathers downstream, so
            # raise (not assert: -O must not disable it, review r5).
            raise ValueError("window base exceeds its own entries")
        # Local columns are window-relative and small: narrow storage
        # cuts the column-index HBM traffic (the kernel widens on load).
        # rank_nb <= 2 layouts (every W<=2 binned build) fit uint8 —
        # 1B/slot instead of 2, ~17% less slab traffic on the
        # memory-bound irregular classes.
        lmax = int(lcols.max()) if lcols.size else 0
        lcols = lcols.astype(
            np.uint8 if lmax < 2**8
            else np.int16 if lmax < 2**15
            else np.int32
        )

        # Pack per-sublane deltas into two int32 words per sub-tile.
        sub_b0 = sub_base.min(axis=1)
        deltas = sub_base - sub_b0[:, None]
        if deltas.size and deltas.max() > 255:
            raise ValueError(
                "sub-tile block span exceeds the packed-delta range (256 "
                "blocks); use the plain SellSlabs kernel for this matrix"
            )
        deltas = deltas.astype(np.uint32)
        sub_dlo = np.zeros(S, dtype=np.uint32)
        sub_dhi = np.zeros(S, dtype=np.uint32)
        for r in range(4):
            sub_dlo |= deltas[:, r] << (8 * r)
            sub_dhi |= deltas[:, r + 4] << (8 * r)
        layout = cls(
            vals=vals.astype(val_dtype or np.float32, copy=False),
            lcols=lcols,
            sub_b0=sub_b0.astype(np.int32),
            sub_dlo=sub_dlo.view(np.int32),
            sub_dhi=sub_dhi.view(np.int32),
            sub_chunk=host["sub_chunk"].astype(np.int32),
            m=host["m"],
            n=host["n"],
            nnz=mat.nnz,
            num_chunks=host["num_chunks"],
            rank_nb=rank_nb,
            chunk_q=host["chunk_q"],
            grp_b0=grp_b0,
            group_code=group_code,
        )
        return layout if on_host else _to_device(layout)
