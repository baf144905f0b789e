"""DIA (diagonal-offset) layout for stencil-structured matrices.

The reference dispatches among formats by structure (CSR / CSR-2 / CSR-3
via reformat-auto's density models, AVX-512 lt4/gt4 kernels by row
density — spmv-csrk/main.c, reformat-csr-to-csr3/main-auto.c); this is
the analog for the grid-stencil end of its benchmark set (ecology1,
G3_circuit, thermal2-class matrices ARE 2D/3D grid problems,
helpers/params.txt).

When every nonzero lies on one of D << m constant diagonals
(col - row = off_k), storing the matrix as D dense diagonals removes the
column indices entirely (4 B/nnz vs 6+ for val+lcol slabs) and turns the
gather into D shifted reads of x: y = sum_k vals[k] * x[row + off_k].

Layout: DIAGONAL-MAJOR — vals[k, row] = A[row, row + off_k], zero where
the diagonal exits the matrix, so each diagonal is one contiguous stream.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.csr import CSRMatrix

# Planner/layout admission: more distinct diagonals than this, or more
# fill than DIA_MAX_FILL, and the slab formats win (their traffic is
# O(nnz), DIA's is O(D * m)).
DIA_MAX_DIAGS = 40
DIA_MAX_FILL = 1.6


def diagonal_profile(mat: CSRMatrix, sample_rows: int = 0):
    """(num_diagonals, fill) of the matrix's diagonal structure.

    fill = D * m / nnz is the traffic ratio DIA pays vs ideal CSR vals.
    sample_rows > 0 estimates D from that many evenly spaced rows (the
    planner's cheap probe); 0 scans every nonzero (exact, O(nnz)).
    """
    if mat.nnz == 0 or mat.m != mat.n:
        return np.iinfo(np.int32).max, float("inf")
    if sample_rows and mat.m > sample_rows:
        step = mat.m // sample_rows
        rows = np.arange(0, mat.m, step, dtype=np.int64)
        parts = []
        for r in rows:
            lo, hi = int(mat.indptr[r]), int(mat.indptr[r + 1])
            parts.append(mat.indices[lo:hi].astype(np.int64) - r)
        offs = np.unique(np.concatenate(parts)) if parts else np.zeros(0)
    else:
        rows = np.repeat(
            np.arange(mat.m, dtype=np.int64), mat.row_lengths
        )
        offs = np.unique(mat.indices.astype(np.int64) - rows)
    d = int(offs.size)
    return d, d * mat.m / max(mat.nnz, 1)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiaSlabs:
    """D dense diagonals, diagonal-major (see module doc)."""

    vals: jax.Array  # (D, m): vals[k, row] = A[row, row + offsets[k]]
    offsets: tuple  # D static diagonal offsets (col - row), ascending
    m: int
    n: int
    nnz: int

    def tree_flatten(self):
        return (self.vals,), (self.offsets, self.m, self.n, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)

    @property
    def padding_ratio(self) -> float:
        return self.vals.size / max(self.nnz, 1)

    @property
    def hbm_bytes(self) -> int:
        # Diagonal values + x read once + y written once.
        return (
            self.vals.size * self.vals.dtype.itemsize
            + 4 * (self.n + self.m)
        )

    @classmethod
    def from_csr(
        cls,
        mat: CSRMatrix,
        max_diags: int = DIA_MAX_DIAGS,
        max_fill: float = DIA_MAX_FILL,
        val_dtype=None,
    ) -> "DiaSlabs":
        """Build the diagonal layout; raises ValueError when the matrix
        is not diagonal-structured enough (the planner's probe should
        normally have filtered it first).

        val_dtype: value storage dtype (default float32). DIA traffic is
        almost entirely values (no indices), so jnp.bfloat16 nearly
        halves the kernel's device bytes; same rounded-operator accuracy
        contract as RankedSlabs.from_csr."""
        if mat.m != mat.n:
            raise ValueError("DIA layout requires a square matrix")
        if mat.nnz == 0:
            # Zero diagonals passes both admission gates below but the
            # kernel cannot form its guard window over an empty offsets
            # tuple: reject like any other non-diagonal input.
            raise ValueError("DIA layout requires a non-empty matrix")
        m = mat.m
        rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
        offs_all = mat.indices.astype(np.int64) - rows
        offsets, inverse = np.unique(offs_all, return_inverse=True)
        d = int(offsets.size)
        if d > max_diags:
            raise ValueError(
                f"{d} distinct diagonals exceeds max_diags={max_diags}"
            )
        fill = d * m / max(mat.nnz, 1)
        if fill > max_fill:
            raise ValueError(
                f"DIA fill {fill:.2f}x exceeds max_fill={max_fill}"
            )
        vals = np.zeros((d, m), np.float32)
        vals[inverse, rows] = mat.data
        return cls(
            vals=jnp.asarray(vals, dtype=val_dtype or jnp.float32),
            offsets=tuple(int(o) for o in offsets),
            m=m,
            n=mat.n,
            nnz=mat.nnz,
        )
