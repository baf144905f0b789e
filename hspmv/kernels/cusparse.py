"""Vendor-library baseline: cuSPARSE through jax.experimental.sparse.

The reference benchmarks its CSR-k kernels against cuSPARSE's generic
cusparseSpMV (cusparse-spmv/spmv.cu:153-190). JAX reaches the same
routine through ``jax.experimental.sparse.csr_matvec``, whose CUDA
lowering calls cuSPARSE for float32 and float64 values. For any other
value type that lowering would silently fall back to a gather/scatter;
this module turns that fallback warning into an error, so the baseline
is cuSPARSE or nothing. On the CPU the same call runs JAX's portable
implementation (tests).
"""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.csr import CSRMatrix


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CSRDevice:
    """CSR arrays on the device: (data, indices, indptr)."""

    data: jax.Array  # (nnz,) float32
    indices: jax.Array  # (nnz,) int32
    indptr: jax.Array  # (m + 1,) int32
    m: int
    n: int
    nnz: int

    def tree_flatten(self):
        return (self.data, self.indices, self.indptr), (self.m, self.n, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def hbm_bytes(self) -> int:
        return 8 * self.nnz + 4 * (self.m + 1) + 4 * (self.n + self.m)

    @classmethod
    def from_csr(cls, mat: CSRMatrix) -> "CSRDevice":
        return cls(
            data=jnp.asarray(mat.data, jnp.float32),
            indices=jnp.asarray(mat.indices, jnp.int32),
            indptr=jnp.asarray(mat.indptr, jnp.int32),
            m=mat.m, n=mat.n, nnz=mat.nnz,
        )


@jax.jit
def _matvec(layout: CSRDevice, x: jax.Array) -> jax.Array:
    from jax.experimental.sparse import CSR, csr_matvec

    with jax.named_scope("spmv_cusparse"):
        mat = CSR(
            (layout.data, layout.indices, layout.indptr),
            shape=(layout.m, layout.n),
        )
        return csr_matvec(mat, x.astype(jnp.float32))


def spmv_cusparse(layout: CSRDevice, x: jax.Array) -> jax.Array:
    """y = A @ x via cuSPARSE's CSR SpMV (on the GPU).

    The fallback warning is an error while this call lowers; the value
    type is checked up front too, because a call traced inside an outer
    jit lowers after this function has returned."""
    from jax.experimental.sparse.util import CuSparseEfficiencyWarning

    if layout.data.dtype not in (jnp.float32, jnp.float64):
        raise TypeError(
            f"cuSPARSE SpMV takes float32/float64 values, not "
            f"{layout.data.dtype}"
        )
    with warnings.catch_warnings():
        warnings.simplefilter("error", CuSparseEfficiencyWarning)
        return _matvec(layout, x)


def lowers_to_cusparse(layout: CSRDevice, x) -> bool:
    """True when spmv_cusparse lowers to a cuSPARSE call on the default
    device (always False on the CPU, which has no cuSPARSE)."""
    text = _matvec.lower(layout, x).as_text()
    return "cusparse" in text.lower()


def spmv_cusparse_reference(layout: CSRDevice, x) -> np.ndarray:
    """NumPy CSR matvec over the device arrays (tests)."""
    indptr = np.asarray(layout.indptr)
    rows = np.repeat(np.arange(layout.m), np.diff(indptr))
    y = np.zeros(layout.m, np.float64)
    np.add.at(
        y, rows,
        np.asarray(layout.data, np.float64)
        * np.asarray(x, np.float64)[np.asarray(layout.indices)],
    )
    return y.astype(np.float32)
