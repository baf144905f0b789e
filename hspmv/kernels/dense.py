"""Dense-GEMV baseline: the "what if A were dense" datum.

Third measured vendor-baseline-role kernel beside segsum and cuSPARSE
(the reference benchmarks four vendor libraries per matrix —
mkl-spmv/spmv.cpp:132-160, cusparse-spmv/spmv.cu:153-190, hipsparse,
kokkos). A measured dense y = A x over the densified operator (XLA
hands it to cuBLAS) quantifies, per matrix, the point where
structure-blind streaming loses to the sparse layouts — the operator
bytes scale with m*n, not nnz; tools/analyze.py dense_roofline is the
closed-form version of the same datum. The product runs at full f32
precision (no TF32).

Materializing a dense (m, n) f32 array caps this baseline at small
matrices: `DenseLayout.from_csr` refuses beyond `max_elems` (default
64M elements = 256 MB HBM) — the sweep's small/tiny scales.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.csr import CSRMatrix

DENSE_MAX_ELEMS = 64 * 2**20


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseLayout:
    """Densified operator (m, n) float32."""

    a: jax.Array
    m: int
    n: int
    nnz: int

    def tree_flatten(self):
        return (self.a,), (self.m, self.n, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @property
    def hbm_bytes(self) -> int:
        return self.a.size * self.a.dtype.itemsize + 4 * (self.n + self.m)

    @classmethod
    def from_csr(
        cls, mat: CSRMatrix, max_elems: int = DENSE_MAX_ELEMS
    ) -> "DenseLayout":
        if mat.m * mat.n > max_elems:
            raise ValueError(
                f"dense baseline capped at {max_elems} elements "
                f"({mat.m}x{mat.n} requested); use the sparse kernels"
            )
        a = np.zeros((mat.m, mat.n), np.float32)
        rows = np.repeat(
            np.arange(mat.m, dtype=np.int64),
            np.diff(mat.indptr).astype(np.int64),
        )
        a[rows, mat.indices.astype(np.int64)] = mat.data
        return cls(jnp.asarray(a), mat.m, mat.n, mat.nnz)


@jax.jit
def spmv_dense(layout: DenseLayout, x: jax.Array) -> jax.Array:
    """y = A @ x on the densified operator."""
    return jnp.matmul(
        layout.a, x.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST
    )
