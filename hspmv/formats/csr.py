"""Host-side CSR matrix container.

Plays the role of the raw (r_vec, c_vec, val) arrays that every reference
driver carries around (reference: spmv-csr/spmv.c:11-57 readers and the
CSRk_Graph ctor spmv-csrk/csrk.cpp:357-467), redesigned as a single NumPy
value type shared by all layers of the framework.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """Compressed-sparse-row matrix with float32 values.

    Attributes:
      indptr:  (m+1,) int32 row pointers, indptr[0] == 0.
      indices: (nnz,) int32 0-based column indices.
      data:    (nnz,) float32 values.
      shape:   (m, n).
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    def __post_init__(self):
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32)
        self.data = np.ascontiguousarray(self.data, dtype=np.float32)
        m, n = self.shape
        self.shape = (int(m), int(n))
        if self.indptr.ndim != 1 or self.indptr.shape[0] != self.shape[0] + 1:
            raise ValueError(
                f"indptr has shape {self.indptr.shape}, expected ({self.shape[0] + 1},)"
            )
        if self.indptr[0] != 0:
            raise ValueError("indptr[0] must be 0 (0-based CSR)")
        if self.indices.shape[0] != self.data.shape[0]:
            raise ValueError("indices and data must have equal length")
        if int(self.indptr[-1]) != self.indices.shape[0]:
            raise ValueError(
                f"indptr[-1]={int(self.indptr[-1])} != nnz={self.indices.shape[0]}"
            )

    # ---- basic properties -------------------------------------------------

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def density(self) -> float:
        """Average nonzeros per row (the reference's tuning density d=nnz/m)."""
        return self.nnz / max(self.m, 1)

    # ---- constructors -----------------------------------------------------

    @classmethod
    def from_coo(
        cls, rows, cols, vals, shape, sum_duplicates: bool = True
    ) -> "CSRMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float32)
        m, n = shape
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if same.any():
                keep = np.concatenate(([True], ~same))
                group = np.cumsum(keep) - 1
                out_vals = np.zeros(int(group[-1]) + 1, dtype=np.float64)
                np.add.at(out_vals, group, vals.astype(np.float64))
                rows, cols = rows[keep], cols[keep]
                vals = out_vals.astype(np.float32)
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr.astype(np.int32), cols.astype(np.int32), vals, (m, n))

    @classmethod
    def from_scipy(cls, sp) -> "CSRMatrix":
        sp = sp.tocsr()
        sp.sort_indices()
        return cls(sp.indptr, sp.indices, sp.data.astype(np.float32), sp.shape)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix((self.data, self.indices, self.indptr), shape=self.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        for i in range(self.m):
            s, e = self.indptr[i], self.indptr[i + 1]
            out[i, self.indices[s:e]] = self.data[s:e]
        return out

    # ---- reference-protocol operations -------------------------------------

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Serial oracle SpMV (reference: test_spmv, spmv-csr/spmv.c:68-90).

        Row-by-row dot products in float32, matching the accumulation
        semantics of the reference's validation oracle.
        """
        x = np.asarray(x, dtype=np.float32)
        y = np.zeros(self.m, dtype=np.float32)
        if self.nnz == 0 or self.m == 0:
            return y
        # Vectorized per-row segmented accumulation in f64 then cast keeps a
        # closer match to serial f32 than np.add.at in f32, while being fast.
        prods = self.data.astype(np.float64) * x[self.indices].astype(np.float64)
        # Prefix-sum difference handles empty rows anywhere (reduceat cannot:
        # clipping its starts truncates the segment before trailing empties).
        csum = np.concatenate(([0.0], np.cumsum(prods)))
        ptr = self.indptr.astype(np.int64)
        sums = csum[ptr[1:]] - csum[ptr[:-1]]
        y[:] = sums.astype(np.float32)
        return y

    def rounded(self, dtype) -> "CSRMatrix":
        """Same pattern with values round-tripped through `dtype`
        (e.g. jnp.bfloat16): the exact operator a val_dtype-reduced
        layout stores, and therefore the oracle such runs validate
        against (tools/spmv.py, tools/spmm.py, tests/test_bf16.py)."""
        import jax.numpy as jnp

        return CSRMatrix(
            self.indptr,
            self.indices,
            np.asarray(jnp.asarray(self.data, dtype), dtype=np.float32),
            self.shape,
        )

    def diagonal(self) -> np.ndarray:
        """A[i, i] as a dense (m,) float32 vector (0 where absent).

        Jacobi preconditioning (tools/solve.py) and scaling diagnostics.
        """
        rows = np.repeat(
            np.arange(self.m, dtype=np.int64), self.row_lengths
        )
        hit = rows == self.indices
        out = np.zeros(self.m, np.float32)
        out[rows[hit]] = self.data[hit]
        return out

    def permuted(self, perm: np.ndarray) -> "CSRMatrix":
        """Symmetric permutation A[perm,:][:,perm] with per-row column sort.

        perm is new->old: new row i is old row perm[i]; columns are relabeled
        by the inverse map and re-sorted ascending within each row
        (reference: CSRk_Graph::reorderA, spmv-csrk/csrk.cpp:548-676).
        """
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape[0] != self.m or self.m != self.n:
            raise ValueError("symmetric permutation requires square matrix")
        from hspmv.reorder import native

        if native.available():
            indptr, indices, data = native.permute_symmetric(
                self.indptr, self.indices, self.data, perm
            )
            return CSRMatrix(indptr, indices, data, self.shape)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.m, dtype=np.int64)
        lengths = self.row_lengths[perm].astype(np.int64)
        new_indptr = np.zeros(self.m + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_indptr[1:])
        # Gather each permuted row's slice (vectorized range concatenation:
        # global position j maps to old index starts[row(j)] + offset(j)).
        starts = self.indptr[perm].astype(np.int64)
        total = int(new_indptr[-1])
        take = (
            np.arange(total, dtype=np.int64)
            - np.repeat(new_indptr[:-1], lengths)
            + np.repeat(starts, lengths)
        )
        new_cols = inv[self.indices[take]]
        new_vals = self.data[take]
        # Sort columns ascending within each row.
        row_ids = np.repeat(np.arange(self.m, dtype=np.int64), lengths)
        order = np.lexsort((new_cols, row_ids))
        return CSRMatrix(
            new_indptr.astype(np.int32),
            new_cols[order].astype(np.int32),
            new_vals[order],
            self.shape,
        )

    def row_bands(self) -> np.ndarray:
        """Per-row band = last column - first column (reference: stats.c:86)."""
        bands = np.zeros(self.m, dtype=np.int64)
        nonempty = self.row_lengths > 0
        first = self.indices[self.indptr[:-1][nonempty]]
        last = self.indices[self.indptr[1:][nonempty] - 1]
        bands[nonempty] = last.astype(np.int64) - first.astype(np.int64)
        return bands

    def stats(self) -> dict:
        """Matrix-structure diagnostics (reference: spmv-csr/stats.c:57-123)."""
        lens = self.row_lengths
        bands = self.row_bands()
        m = max(self.m, 1)
        avg = self.nnz / m
        return {
            "nnz_avg": avg,
            "nnz_min": int(lens.min()) if self.m else 0,
            "nnz_max": int(lens.max()) if self.m else 0,
            "nnz_var": float(((lens - avg) ** 2).sum() / m),
            "band_avg": float(bands.mean()) if self.m else 0.0,
            "band_min": int(bands.min()) if self.m else 0,
            "band_max": int(bands.max()) if self.m else 0,
            "band_var": float(((bands - bands.mean()) ** 2).sum() / m) if self.m else 0.0,
            "total_nnz": self.nnz,
            "dim": self.shape,
        }
