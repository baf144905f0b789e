"""SpMV over the SELL-slab layouts (formats/sell.py).

Role-equivalent of the reference's CSR-k kernels (CSRk_Graph::SpMV
spmv-csrk/csrk.cpp:149-330 and cuSpMV_2/3/3_vec
cuda-spmv-csrk/cuda/csrk.cu:184-391): rows of a 128-row chunk are the
lanes, the chunk's nonzeros are its slot rows, and each row's sum is a
reduction over its lane.

  spmv_sell   — absolute columns (SellSlabs)
  spmv_ranked — window-relative columns with per-sublane bases
                (RankedSlabs); the int16/uint8 local columns save index
                bytes, the absolute column is decoded on the fly

Both run the shared slab body (kernels/slab.py) and are plain XLA. Given
X of shape (n, B) they compute the SpMM Y = A @ X of shape (m, B): the
slab traffic is paid once for all B columns, and each slot gathers one
row of X, B contiguous floats.
"""

from __future__ import annotations

import jax
import numpy as np

from hspmv.formats.sell import LANES, SUBLANES, RankedSlabs, SellSlabs
from hspmv.kernels.slab import ranked_columns, reduce_partials, subtile_partials


@jax.jit
def spmv_sell(layout: SellSlabs, x: jax.Array) -> jax.Array:
    """y = A @ x with A in SELL-slab layout. x: (n[, B]) -> y: (m[, B])
    float32."""
    with jax.named_scope("spmv_sell"):
        return reduce_partials(
            subtile_partials(layout.vals, layout.cols, x), layout
        )


@jax.jit
def spmv_ranked(layout: RankedSlabs, x: jax.Array) -> jax.Array:
    """y = A @ x with A in rank-windowed SELL layout; x: (n[, B])."""
    with jax.named_scope("spmv_ranked"):
        cols = ranked_columns(layout)
        return reduce_partials(subtile_partials(layout.vals, cols, x), layout)


def spmv_sell_reference(layout: SellSlabs, x: np.ndarray) -> np.ndarray:
    """NumPy emulation of the slab accumulation order, for tests."""
    vals = np.asarray(layout.vals, dtype=np.float32)
    cols = np.asarray(layout.cols)
    xp = np.asarray(x, dtype=np.float32)
    gathered = np.where(cols < xp.shape[0], xp[np.clip(cols, 0, xp.shape[0] - 1)], 0.0)
    prods = (vals * gathered).astype(np.float32)
    total_k = vals.shape[0]
    partials = prods.reshape(total_k // SUBLANES, SUBLANES, LANES).sum(axis=1)
    y = np.zeros((layout.num_chunks + 1, LANES), dtype=np.float32)
    np.add.at(y, np.asarray(layout.sub_chunk), partials)
    return y[:-1].reshape(-1)[: layout.m]
