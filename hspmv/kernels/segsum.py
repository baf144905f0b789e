"""Pure-XLA SpMV baseline: gather + segment-sum.

This plays the role the vendor baselines (MKL/cuSPARSE/hipSPARSE/Kokkos,
reference: mkl-spmv/spmv.cpp:132-160, cusparse-spmv/spmv.cu:153-190) play
in the reference suite: a library-quality, format-agnostic datum that the
tuned CSR-k kernels are measured against. It relies entirely on XLA's
gather and segment-sum lowering.

The layout is static-shape friendly: nnz padded to a multiple of 8*128 with
out-of-range-safe fill (col=0, val=0, row=m sentinel dropped by
segment_sum's num_segments).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.csr import CSRMatrix


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SegsumLayout:
    """Device arrays for the segment-sum kernel."""

    rows: jax.Array  # (nnz_pad,) int32 row id per nonzero (m for padding)
    cols: jax.Array  # (nnz_pad,) int32 column id per nonzero (0 for padding)
    vals: jax.Array  # (nnz_pad,) float32 (0 for padding)
    m: int
    n: int
    nnz: int

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.m, self.n, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_csr(cls, mat: CSRMatrix, pad_to: int = 1024) -> "SegsumLayout":
        nnz_pad = max(_round_up(mat.nnz, pad_to), pad_to)
        rows = np.full(nnz_pad, mat.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=np.float32)
        rows[: mat.nnz] = np.repeat(
            np.arange(mat.m, dtype=np.int32), mat.row_lengths
        )
        cols[: mat.nnz] = mat.indices
        vals[: mat.nnz] = mat.data
        return cls(
            rows=jnp.asarray(rows),
            cols=jnp.asarray(cols),
            vals=jnp.asarray(vals),
            m=mat.m,
            n=mat.n,
            nnz=mat.nnz,
        )


@partial(jax.jit, static_argnames=("num_segments",))
def _segsum(rows, cols, vals, x, num_segments):
    prods = vals * jnp.take(x, cols, axis=0)
    y = jax.ops.segment_sum(
        prods, rows, num_segments=num_segments + 1, indices_are_sorted=True
    )
    return y[:-1]


def spmv_segsum(layout: SegsumLayout, x: jax.Array) -> jax.Array:
    """y = A @ x via XLA gather + sorted segment-sum."""
    return _segsum(layout.rows, layout.cols, layout.vals, x, layout.m)
