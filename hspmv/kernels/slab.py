"""The slab SpMV/SpMM body every SELL-family layout shares, in plain XLA.

A slab layout stores each 128-row chunk's nonzeros as slot rows of 128
lanes: ``vals[k, lane]`` and the column it multiplies, one lane per row
(formats/sell.py, formats/packed.py). The product is

    y[chunk * 128 + lane] = sum over the chunk's slot rows k of
                            vals[k, lane] * x[col[k, lane]]

so every layout runs the same three steps: gather ``x`` at the absolute
columns, multiply, and sum the slot rows of each chunk. The layouts
differ only in how they store the columns (absolute, or window-relative
``lcols`` plus a per-sublane base) and in how slot rows map to chunks
(whole 8-row sub-tiles, or back-to-back mixed heights). Those two
differences are the helpers below; XLA fuses the gather, the multiply
and the sub-tile sum into one pass over the slabs.

``x`` may carry a trailing batch axis (SpMM): ``X[col]`` then gathers B
contiguous floats per index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hspmv.formats.sell import LANES, SUBLANES


def gather_products(vals: jax.Array, cols: jax.Array, x: jax.Array) -> jax.Array:
    """(K, 128[, B]) float32 products vals * x[cols]. Padding slots hold
    val 0 and an in-range column, so they contribute nothing."""
    g = jnp.take(x.astype(jnp.float32), cols, axis=0, mode="clip")
    v = vals.astype(jnp.float32)
    if x.ndim == 2:
        v = v[..., None]
    return v * g


def subtile_partials(vals: jax.Array, cols: jax.Array, x: jax.Array) -> jax.Array:
    """(S, 128[, B]) row sums over each 8-slot sub-tile."""
    prod = gather_products(vals, cols, x)
    return prod.reshape(
        prod.shape[0] // SUBLANES, SUBLANES, *prod.shape[1:]
    ).sum(axis=1)


def reduce_partials(partials: jax.Array, layout) -> jax.Array:
    """Chunk totals from sub-tile partials -> y (m[, B]).

    Uniform layouts (chunk_q > 0) reduce with a reshape-sum, or nothing
    at q == 1; ragged layouts with a sorted segment-sum over sub-tiles.
    """
    q = layout.chunk_q
    nc = layout.num_chunks
    tail = partials.shape[2:]
    if q == 1:
        out = partials[:nc]
    elif q:
        out = partials[: nc * q].reshape(nc, q, LANES, *tail).sum(axis=1)
    else:
        out = jax.ops.segment_sum(
            partials, layout.sub_chunk, num_segments=nc + 1,
            indices_are_sorted=True,
        )[:nc]
    return out.reshape(nc * LANES, *tail)[: layout.m]


def sublane_bases(layout) -> jax.Array:
    """(S, 8) window base (in 128-column blocks) of every sublane of a
    rank-windowed layout: the group's absolute base for grouped layouts,
    else sub_b0 plus the four 8-bit deltas packed in sub_dlo / sub_dhi."""
    S = layout.num_subtiles
    if layout.group_code:
        groups = layout.groups
        G = max(groups) + 1
        return layout.grp_b0.reshape(S, G)[:, jnp.asarray(groups)]
    shifts = jnp.arange(4, dtype=jnp.int32)[None, :] * 8
    unpack = lambda w: jax.lax.shift_right_logical(
        jnp.broadcast_to(w[:, None], (S, 4)), jnp.broadcast_to(shifts, (S, 4))
    ) & 255
    deltas = jnp.concatenate(
        [unpack(layout.sub_dlo), unpack(layout.sub_dhi)], axis=1
    )
    return layout.sub_b0[:, None] + deltas


def ranked_columns(layout) -> jax.Array:
    """(K, 128) absolute columns of a rank-windowed layout:
    col = 128 * base[sublane] + lcol."""
    S = layout.num_subtiles
    base = sublane_bases(layout) * LANES
    lc = layout.lcols.reshape(S, SUBLANES, LANES).astype(jnp.int32)
    return (base[:, :, None] + lc).reshape(S * SUBLANES, LANES)


def packed_slot_chunks(layout) -> jax.Array:
    """(K,) owning chunk of every slot row of a packed mixed-height
    layout (num_chunks for the inert tail), decoded from the per-chunk
    emit rows (out_row) and the sub-tile boundaries (bmeta)."""
    K = int(layout.vals.shape[0])
    s_of = layout.out_row // 2
    meta = layout.bmeta[s_of]
    bound = jnp.where(layout.out_row % 2 == 0, meta & 15, (meta >> 4) & 15)
    ends = SUBLANES * s_of + bound  # exclusive end slot of each chunk
    marks = jnp.zeros(K + 1, jnp.int32).at[ends].add(1)
    return jnp.cumsum(marks)[:K]
