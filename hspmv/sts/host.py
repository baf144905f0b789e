"""Host preprocessing for sparse triangular solve.

Reproduces the semantics of the reference's STS pipeline
(preprocessingForSTS spmv-csrk/csrk.cpp:1522-1966) with vectorized NumPy
and re-designs the schedule for the device solve:

  reference                          this module
  ---------                          -----------
  find_levels (csrk.cpp:2704-2820)   find_levels: dependency levels of the
                                     lower triangle (level scheduling)
  BGL_ordering (csrk.cpp:2946-3009)  greedy_color: first-fit greedy
                                     coloring in vertex order (the exact
                                     algorithm Boost's
                                     sequential_vertex_coloring runs)
  pack sort by increasing size       build_sts(sort_packs=True) keeps the
  (csrk.cpp:1616-1654)               reference's pack ordering rule
  incomplete_choloskey               split_lu: structural L/U split of the
  (csrk.cpp:708-789)                 permuted matrix
  compute_b (csrk.cpp:791-808)       compute_b: b = L @ x_exact oracle
  STS-k coarse packs                 build_sts(k>=3): coarsen+color the
  (csrk.cpp:1747-1966)               coarse graph; fine rows of one
                                     super-row become sequential steps

The key invariant both orderings guarantee: rows inside one pack are
mutually independent in the permuted lower triangle (colors: no edges at
all inside a pack; level sets: an edge between same-level rows would make
one depend on the other, contradicting the level assignment). The
device solve therefore runs packs in order and all rows of a pack in
parallel (hspmv/sts/solve.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hspmv.formats.csr import CSRMatrix





def split_lu(mat: CSRMatrix) -> tuple[CSRMatrix, CSRMatrix]:
    """Structural split into L (incl. diagonal) and U (incl. diagonal).

    Reference: CSRk_Graph::incomplete_choloskey (csrk.cpp:708-789), which
    despite its name only splits the nonzero structure — no factorization.
    Requires every diagonal entry to be present (the reference exits on a
    missing self edge, csrk.cpp:731-734).
    """
    m, n = mat.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
    cols = mat.indices.astype(np.int64)
    lower = cols <= rows
    upper = cols >= rows
    diag_count = int(np.sum(cols == rows))
    if diag_count != m:
        raise ValueError(
            f"matrix is missing {m - diag_count} diagonal entries; "
            "STS requires a full diagonal"
        )

    def pick(mask):
        sel_rows = rows[mask]
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(indptr, sel_rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRMatrix(
            indptr.astype(np.int32), mat.indices[mask], mat.data[mask], (m, n)
        )

    return pick(lower), pick(upper)


def reversed_for_upper(mat: CSRMatrix):
    """Row+column reversal: the UPPER triangle of `mat` becomes the
    LOWER triangle of the returned matrix, so the chunk-sequential
    lower-solve machinery performs the backward (upper) substitution —
    solve the reversed system, read the solution back through the same
    reversal. Returns (reversed matrix, reversal permutation; an
    involution). The reference ships only lowerSTS (csrk.cpp:79-145);
    the upper solve is net-new.

    Triangle-exact solves (match scipy's triu solve on the ORIGINAL
    matrix, arbitrary rhs) need a triangular input + order LS +
    sort_packs=False: build_sts splits after permuting (the reference's
    semantics), so a pack-size sort may flip full-matrix entries across
    the diagonal — see tests/test_sts.py::test_upper_solve_scipy_parity.
    The CLI's x=ones protocol is self-consistent under any order."""
    rev = np.arange(mat.m - 1, -1, -1, dtype=np.int64)
    return mat.permuted(rev), rev


def find_levels(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Dependency level of each row in the lower triangle.

    level[i] = 1 + max(level[j]) over structural deps j < i in row i
    (0 for rows with no sub-diagonal entries). This is the schedule the
    reference's find_levels computes by repeated candidate scanning
    (csrk.cpp:2704-2820); here it is a wavefront sweep: each pass fixes
    every row whose dependencies are all fixed, processing only still-
    unfixed rows (total work O(nnz * depth / average wavefront) but each
    pass is fully vectorized).
    """
    from hspmv.reorder import native

    if native.available():
        return native.level_schedule(indptr, indices)

    m = indptr.shape[0] - 1
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    strict = cols < rows
    dep_rows = rows[strict]
    dep_cols = cols[strict]

    level = np.zeros(m, dtype=np.int64)
    # Rows with no strict-lower entries are level 0 already.
    ndeps = np.zeros(m, dtype=np.int64)
    np.add.at(ndeps, dep_rows, 1)
    fixed = ndeps == 0

    # Iterate: a row becomes fixed when all deps fixed; its level is
    # 1 + max dep level. Work on the unfixed frontier only.
    dep_order = np.argsort(dep_rows, kind="stable")
    dep_rows = dep_rows[dep_order]
    dep_cols = dep_cols[dep_order]
    dep_ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(dep_ptr, dep_rows + 1, 1)
    np.cumsum(dep_ptr, out=dep_ptr)

    pending = np.flatnonzero(~fixed)
    while pending.size:
        # Per pending row: are all deps fixed? max dep level?
        starts = dep_ptr[pending]
        lens = dep_ptr[pending + 1] - starts
        take = (
            np.arange(int(lens.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(lens) - lens, lens)
            + np.repeat(starts, lens)
        )
        seg = np.repeat(np.arange(pending.size, dtype=np.int64), lens)
        dfixed = fixed[dep_cols[take]]
        all_fixed = np.ones(pending.size, dtype=bool)
        np.logical_and.at(all_fixed, seg, dfixed)
        dlevel = level[dep_cols[take]]
        maxlev = np.zeros(pending.size, dtype=np.int64)
        np.maximum.at(maxlev, seg, dlevel)
        ready = all_fixed
        if not ready.any():
            raise RuntimeError("level scheduling stalled (cyclic structure?)")
        rows_ready = pending[ready]
        level[rows_ready] = maxlev[ready] + 1
        fixed[rows_ready] = True
        pending = pending[~ready]
    return level


def greedy_color(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """First-fit greedy coloring in vertex order.

    The exact algorithm behind the reference's BGL_ordering
    (boost::sequential_vertex_coloring, csrk.cpp:2946-3009): visit
    vertices 0..n-1, give each the smallest color unused among its
    already-colored neighbors. Serial by nature; the native C++ core is
    used when available (hspmv/cpp/reorder.cc).
    """
    from hspmv.reorder import native

    if native.available() and hasattr(native, "greedy_color"):
        return native.greedy_color(indptr, indices)
    m = indptr.shape[0] - 1
    color = np.full(m, -1, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    mark = np.full(m + 1, -1, dtype=np.int64)  # color -> vertex that marked
    for v in range(m):
        nbrs = indices[indptr[v] : indptr[v + 1]]
        ncols = color[nbrs]
        mark[ncols[ncols >= 0]] = v
        c = 0
        while mark[c] == v:
            c += 1
        color[v] = c
    return color


def _coarse_adjacency(mat: CSRMatrix, fine_ptr: np.ndarray):
    """Coarse adjacency: groups a,b adjacent iff any A[i,j] != 0 with
    i in group a, j in group b (the structure the reference builds during
    coarsening, csrk.cpp:1296-1430). fine_ptr: (num_groups+1,) contiguous
    fine-row ranges. Returns (indptr, indices) with self-loops kept."""
    num_groups = fine_ptr.shape[0] - 1
    group_of = np.repeat(
        np.arange(num_groups, dtype=np.int64), np.diff(fine_ptr)
    )
    rows = np.repeat(np.arange(mat.m, dtype=np.int64), mat.row_lengths)
    ga = group_of[rows]
    gb = group_of[mat.indices.astype(np.int64)]
    pairs = np.unique(ga * num_groups + gb)
    cr = pairs // num_groups
    cc = pairs % num_groups
    indptr = np.zeros(num_groups + 1, dtype=np.int64)
    np.add.at(indptr, cr + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, cc


def _packs_from_labels(labels: np.ndarray, sort_packs: bool):
    """Group rows by label into packs; return (perm_new_to_old, pack_ptr).

    sort_packs=True reproduces the reference's 'increasing pack size'
    ordering (csrk.cpp:1616-1654). Pack order is free because the matrix
    is re-permuted afterwards: L is re-derived from the permuted matrix,
    so any pack order yields a consistent triangular system.
    """
    num_packs = int(labels.max()) + 1 if labels.size else 0
    sizes = np.bincount(labels, minlength=num_packs)
    order = np.argsort(sizes, kind="stable") if sort_packs else np.arange(num_packs)
    rank = np.empty(num_packs, dtype=np.int64)
    rank[order] = np.arange(num_packs, dtype=np.int64)
    # Sort rows by (pack rank, original index) -> new->old permutation.
    perm = np.lexsort((np.arange(labels.size), rank[labels]))
    pack_ptr = np.zeros(num_packs + 1, dtype=np.int64)
    np.cumsum(sizes[order], out=pack_ptr[1:])
    return perm.astype(np.int64), pack_ptr


@dataclasses.dataclass
class TriangularSystem:
    """A lower-triangular system in dependency-ordered chunk schedule.

    matrix: the pack-permuted full matrix (for reference-parity drivers).
    lower/upper: structural split of `matrix`.
    perm: new->old row permutation applied (the reference's permBigG).
    pack_ptr: (num_packs+1,) row ranges of each pack in the new order.
    chunk_rows: (num_chunks,) first row of each 128-row solve chunk; the
      device schedule processes chunks in order, all lanes of a chunk in
      parallel (chunks never straddle a pack boundary — padded).
    """

    matrix: CSRMatrix
    lower: CSRMatrix
    upper: CSRMatrix
    perm: np.ndarray
    pack_ptr: np.ndarray
    order_type: str
    k: int

    @property
    def num_packs(self) -> int:
        return self.pack_ptr.shape[0] - 1

    def pack_sizes(self) -> np.ndarray:
        return np.diff(self.pack_ptr)


def build_sts(
    mat: CSRMatrix,
    order_type: str = "LS",
    k: int = 2,
    sup_row_sizes: tuple[int, ...] = (),
    sort_packs: bool = True,
) -> TriangularSystem:
    """Build the pack schedule + permuted triangular system.

    order_type: "LS" (level sets of the lower triangle, reference
      find_levels path csrk.cpp:1608-1673) or "COLOR" (greedy coloring of
      the symmetric structure, BGL path csrk.cpp:1535-1607).
    k: 2 solves fine rows directly; k>=3 coarsens the graph k-2 times
      (hand coarsening + RCM per level, reference stsPreprocessingForHAND
      csrk.cpp:1692-1966) and colors/level-sets the coarsest graph. Fine
      rows of one super-row become sequential dependency levels *within*
      its pack, preserving the reference's serial-inside-super-row
      semantics (lowerSTS k=3/4, csrk.cpp:92-143) in a form the chunked
      level-scheduled solve executes directly.
    """
    if mat.m != mat.n:
        raise ValueError("STS requires a square matrix")
    if order_type not in ("LS", "COLOR"):
        raise ValueError(f"unknown order_type {order_type!r}")

    if k == 2:
        if order_type == "COLOR":
            labels = greedy_color(mat.indptr, mat.indices)
        else:
            labels = find_levels(mat.indptr, mat.indices)
        perm, pack_ptr = _packs_from_labels(labels, sort_packs)
    elif k >= 3:
        from hspmv.formats.csrk import CSRkMatrix

        # Coarsen k-2 times with RCM at each level (the reference runs
        # BAND_k(k-1) so its innermost loop count matches ours).
        sizes = sup_row_sizes or tuple([32] * (k - 2))
        if len(sizes) != k - 2:
            raise ValueError(f"k={k} needs {k - 2} sup_row_sizes, got {len(sizes)}")
        csrk = CSRkMatrix.build(mat, k=k - 1, sup_row_sizes=sizes)
        # Compose level maps down to fine-row ranges of the coarsest level
        # (ranges are contiguous in the final numbering).
        coarse_map = csrk.maps[0]
        for higher in csrk.maps[1:]:
            coarse_map = coarse_map[higher]
        c_indptr, c_indices = _coarse_adjacency(csrk.matrix, coarse_map)
        if order_type == "COLOR":
            clabels = greedy_color(c_indptr, c_indices)
        else:
            clabels = find_levels(c_indptr, c_indices)
        cperm, cpack_ptr = _packs_from_labels(clabels, sort_packs)

        # Fine permutation: packs of super-rows; inside a pack, fine rows
        # of one super-row are sequential steps -> order fine rows by
        # (pack, step, super-row) so each step is one independent set.
        num_coarse = cperm.shape[0]
        fine_of = [
            np.arange(coarse_map[c], coarse_map[c + 1], dtype=np.int64)
            for c in range(num_coarse)
        ]
        perm_parts = []
        labels_parts = []
        step_base = 0
        for p in range(cpack_ptr.shape[0] - 1):
            members = cperm[cpack_ptr[p] : cpack_ptr[p + 1]]
            rows_by_step: list[list[np.ndarray]] = []
            for c in members:
                rows = fine_of[c]
                for s, r in enumerate(rows):
                    if s >= len(rows_by_step):
                        rows_by_step.append([])
                    rows_by_step[s].append(r)
            for s, rs in enumerate(rows_by_step):
                arr = np.asarray(rs, dtype=np.int64)
                perm_parts.append(arr)
                labels_parts.append(np.full(arr.size, step_base + s))
            step_base += len(rows_by_step)
        # Steps are the real dependency packs for the solver (the
        # per-coarse-pack boundaries are NOT the solver's packs —
        # _packs_from_labels derives the real ones below, review r5
        # removed a dead accumulator that suggested otherwise).
        csrk_perm = np.concatenate(perm_parts) if perm_parts else np.empty(0, np.int64)
        labels = np.concatenate(labels_parts) if labels_parts else np.empty(0, np.int64)
        # Map through the CSR-k permutation (csrk.matrix rows are already
        # permuted by csrk.perm, new->old).
        perm = csrk.perm[csrk_perm]
        _, pack_ptr = _packs_from_labels(labels, sort_packs=False)
    else:
        raise ValueError(f"STS is not defined for k={k} (reference: k in 2..4)")

    pm = mat.permuted(perm)
    lower, upper = split_lu(pm)
    return TriangularSystem(
        matrix=pm,
        lower=lower,
        upper=upper,
        perm=perm,
        pack_ptr=np.asarray(pack_ptr, dtype=np.int64),
        order_type=order_type,
        k=k,
    )


def compute_b(lower: CSRMatrix, x_exact: np.ndarray | None = None) -> np.ndarray:
    """b = L @ x_exact with x_exact defaulting to ones.

    Reference: CSRk_Graph::compute_b (csrk.cpp:791-808) builds b from
    x_test = 1.0 so the solve has a known answer.
    """
    if x_exact is None:
        x_exact = np.ones(lower.m, dtype=np.float32)
    return lower.matvec(x_exact)


def check_error(x: np.ndarray, x_exact: np.ndarray | None = None) -> float:
    """Signed total error sum(x - x_exact) (reference checkError
    csrk.cpp:809-834)."""
    x = np.asarray(x, dtype=np.float64)
    if x_exact is None:
        x_exact = np.ones_like(x)
    return float(np.sum(x - np.asarray(x_exact, dtype=np.float64)))
