"""SpMV over the packed mixed-height layout (formats/packed.py).

Same window-relative columns as spmv_ranked (kernels/sell.py), but the
chunks' slabs are stacked back to back at slot-row granularity, so an
8-slot sub-tile may hold the end of one chunk and the start of the next.
The shared slab body (kernels/slab.py) forms the products; the slot rows
then reduce into their chunks by a sorted segment-sum, with each slot
row's chunk decoded from the layout's boundary metadata. x may be (n, B), as for spmv_ranked.
"""

from __future__ import annotations

import jax

from hspmv.formats.packed import PackedRanked
from hspmv.formats.sell import LANES
from hspmv.kernels.slab import (
    gather_products, packed_slot_chunks, ranked_columns,
)


@jax.jit
def spmv_packed(layout: PackedRanked, x: jax.Array) -> jax.Array:
    """y = A @ x with A in packed mixed-height rank-windowed layout."""
    with jax.named_scope("spmv_packed"):
        prod = gather_products(layout.vals, ranked_columns(layout), x)
        nc = layout.num_chunks
        sums = jax.ops.segment_sum(
            prod, packed_slot_chunks(layout), num_segments=nc + 1,
            indices_are_sorted=True,
        )[:nc]
        return sums.reshape(nc * LANES, *prod.shape[2:])[: layout.m]
