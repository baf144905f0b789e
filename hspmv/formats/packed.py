"""Packed rank-windowed SELL layout: mixed-height slabs, no 8-row
quantum.

The quantized layouts round every 128-row chunk's slab height up to 8
slot rows so each (8, 128) sub-tile belongs to exactly one chunk. On
~5-nonzero-per-row matrices (RCM'd 5-point grids) that quantum is most
of the padding: height 5 rounds to 8. The reference's CSR-k slabs have
no such floor — its super-rows pack rows back to back
(spmv-csrk/csrk.cpp:149-330).

Here chunk slabs stack back to back at slot-row granularity
(kc = max(true slot count, 4)), so a sub-tile may contain the tail of
one chunk, whole chunks, and the head of the next. Per sub-tile the
layout records (b1, b2, E): the boundary positions of the (at most two,
since kc >= 4) chunk ends inside it and their count, and per chunk the
partial row (out_row = 2s or 2s+1) where its total completes. The
product (kernels/packed.py) decodes each slot row's chunk from that
metadata and reduces by a sorted segment-sum.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from hspmv.formats.csr import CSRMatrix
from hspmv.formats.sell import (
    LANES,
    SUBLANES,
    _aligned_slots,
    _binned_slots,
    _round_up,
    _to_device,
    group_windows,
)

# Minimum slab height: bounds chunk ends per 8-slot sub-tile to two
# (consecutive ends are >= MIN_KC apart; a sub-tile spans 7 positions).
MIN_KC = 4


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PackedRanked:
    """Mixed-height rank-windowed slabs (see module docstring).

    Storage matches RankedSlabs (vals/lcols/sub_b0/sub_dlo/sub_dhi)
    plus:
      bmeta     (S,) int32: b1 | b2 << 4 | E << 8 — the sub-tile's
                segment boundaries and end count
      out_row   (num_chunks,) int32: flat partial-row index (2s or
                2s+1) where this chunk's total is emitted
    """

    vals: jax.Array
    lcols: jax.Array
    sub_b0: jax.Array
    sub_dlo: jax.Array
    sub_dhi: jax.Array
    bmeta: jax.Array
    out_row: jax.Array
    m: int
    n: int
    nnz: int
    num_chunks: int
    rank_nb: int
    # Grouped absolute window bases (see sell.group_windows); the
    # grouped kernel replaces the 8-load packed-delta unpack with G
    # scalar reads + G loads. group_code == 0 disables grouping.
    grp_b0: jax.Array = None
    group_code: int = 0

    def tree_flatten(self):
        children = (
            self.vals, self.lcols, self.sub_b0, self.sub_dlo,
            self.sub_dhi, self.bmeta, self.out_row, self.grp_b0,
        )
        aux = (
            self.m, self.n, self.nnz, self.num_chunks, self.rank_nb,
            self.group_code,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:7], *aux[:5], grp_b0=children[7],
                   group_code=aux[5])

    def save(self, path, matrix=None, config: tuple = ()) -> None:
        from hspmv.formats.sell import _save_layout

        _save_layout(self, path, matrix, config)

    @property
    def groups(self) -> tuple:
        """Static sublane->group map decoded from group_code."""
        return tuple((self.group_code >> (4 * r)) & 15 for r in range(SUBLANES))

    @property
    def num_subtiles(self) -> int:
        return int(self.sub_b0.shape[0])

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
            + 2 * self.num_subtiles * LANES * 4  # two partial rows/sub-tile
        )

    @classmethod
    def from_csr(
        cls, mat: CSRMatrix, allow_groups: bool = True,
        val_dtype=None, bin_blocks: int = 0,
    ) -> "PackedRanked":
        """val_dtype: slab value storage dtype (default float32);
        jnp.bfloat16 halves the value traffic — see
        RankedSlabs.from_csr for the accuracy contract.

        bin_blocks > 0: column-binned slot assignment (_binned_slots)
        instead of cluster-aligned — the irregular-matrix mode. Binned
        slots bound every slot's gather window to `bin_blocks` x blocks
        on matrices with no band clusters (fem/delaunay/road classes),
        and the packed mixed heights remove the 8-row quantum that
        dominates their fill under RankedSlabs.

        Engagement limit: bin_blocks > 0 reuses _binned_slots, whose
        <=255-block window-delta repair runs on the QUANTIZED 8-slot
        groups — packed re-segments slabs at kc granularity, so
        cross-chunk jumps on scattered structure can exceed the
        packed-delta range and raise here (callers fall back to
        RankedSlabs). Repairing at packed granularity is the known
        extension.

        NOTE: the window/delta/pad host build mirrors
        RankedSlabs.from_csr (sell.py) — keep fixes in sync.
        """
        m, n = mat.shape
        num_chunks = max(_round_up(m, LANES) // LANES, 1)

        if bin_blocks:
            ranks, kc_raw = _binned_slots(mat, bin_blocks)
        else:
            ranks, kc_raw = _aligned_slots(mat)
        kc = np.maximum(kc_raw, MIN_KC)
        koff = np.zeros(num_chunks + 1, dtype=np.int64)
        np.cumsum(kc, out=koff[1:])
        total_k = _round_up(int(koff[-1]), SUBLANES)

        # int32 throughout: at high-fill irregular structure the padded
        # (total_k, 128) temporaries dominate build memory, and int64
        # doubles them for column ids that always fit 31 bits (same
        # lesson as SellSlabs._host_build, review r5).
        vals = np.zeros((total_k, LANES), dtype=np.float32)
        cols = np.full((total_k, LANES), -1, dtype=np.int32)
        rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
        dest_k = koff[rows // LANES] + ranks
        dest_l = rows % LANES
        vals[dest_k, dest_l] = mat.data
        cols[dest_k, dest_l] = mat.indices

        # Per-(global sublane) windows over real slots, as in
        # RankedSlabs.from_csr — the window machinery never cared which
        # chunk a sublane belongs to.
        S = total_k // SUBLANES
        units = np.where(cols >= 0, cols >> 7, np.iinfo(np.int32).max)
        big = units.reshape(S, SUBLANES, LANES)
        sub_base = big.min(axis=2)
        empty = sub_base == np.iinfo(np.int32).max
        tile_min = sub_base.min(axis=1)
        tile_min[tile_min == np.iinfo(np.int32).max] = 0
        sub_base = np.where(empty, tile_min[:, None], sub_base)

        # Grouped absolute window bases (same machinery as RankedSlabs:
        # the grouping is a pure function of per-sublane window extents,
        # sell.group_windows — mixed chunk heights do not change it).
        real = cols >= 0
        group_code = 0
        grp_b0 = np.zeros(0, np.int32)
        if allow_groups and S:
            hi_units = np.where(real, units, -1).reshape(
                S, SUBLANES, LANES
            ).max(axis=2)
            hi_units = np.where(hi_units < 0, sub_base, hi_units)
            rank_nb0 = int((hi_units - sub_base).max()) + 1
            sub_base, grp_b0, group_code = group_windows(
                sub_base, hi_units, rank_nb0
            )

        base_cols = np.repeat(
            sub_base.reshape(-1), LANES
        ).reshape(total_k, LANES)
        lcols = np.where(real, cols - (base_cols << 7), 0)
        lmax = int(lcols.max()) if S else 0
        rank_nb = (lmax >> 7) + 1 if S else 1
        if S and int(lcols.min()) < 0:
            raise ValueError("window base exceeds its own entries")
        # uint8 when rank_nb <= 2 (see RankedSlabs.from_csr): 1B/slot
        # column indices on the irregular W<=2 binned classes.
        lcols = lcols.astype(
            np.uint8 if lmax < 2**8
            else np.int16 if lmax < 2**15
            else np.int32
        )

        sub_b0 = sub_base.min(axis=1)
        deltas = sub_base - sub_b0[:, None]
        if deltas.size and deltas.max() > 255:
            raise ValueError(
                "sub-tile block span exceeds the packed-delta range "
                "(256 blocks); use SellSlabs for this matrix"
            )
        deltas = deltas.astype(np.uint32)
        sub_dlo = np.zeros(S, dtype=np.uint32)
        sub_dhi = np.zeros(S, dtype=np.uint32)
        for r in range(4):
            sub_dlo |= deltas[:, r] << (8 * r)
            sub_dhi |= deltas[:, r + 4] << (8 * r)

        # Segment metadata: chunk c's slots end at koff[c+1]-1, i.e. it
        # completes in sub-tile (koff[c+1]-1) // 8 at boundary position
        # koff[c+1] - 8s in (0, 8].
        ends = koff[1:]  # exclusive end slot per chunk
        s_of = (ends - 1) // SUBLANES
        bpos = ends - s_of * SUBLANES  # in (0, 8]
        # Rank of each end within its sub-tile (0 = first, 1 = second):
        # chunk ids ascend with end position, so rank = count of earlier
        # chunks sharing the sub-tile.
        start_idx = np.searchsorted(s_of, np.arange(S), side="left")
        rank_in = np.arange(num_chunks, dtype=np.int64) - start_idx[s_of]
        out_row = 2 * s_of + rank_in

        b1 = np.zeros(S, dtype=np.int64)
        b2 = np.zeros(S, dtype=np.int64)
        E = np.zeros(S, dtype=np.int64)
        np.add.at(E, s_of, 1)
        if int(E.max(initial=0)) > 2:
            # kc >= MIN_KC bounds chunk ends to two per 8-slot sub-tile;
            # bmeta has room for two, and a third would put a chunk's
            # slots into its neighbour's sum SILENTLY — raise, never
            # assert (-O strips asserts; this guards the result).
            raise ValueError(
                ">2 chunk ends in one sub-tile (MIN_KC violated)"
            )
        # First end's boundary -> b1; second -> b2 (else b2 = b1).
        b1[s_of[rank_in == 0]] = bpos[rank_in == 0]
        b2[:] = b1
        b2[s_of[rank_in == 1]] = bpos[rank_in == 1]
        bmeta = (b1 | (b2 << 4) | (E << 8)).astype(np.int32)

        return _to_device(cls(
            vals=vals.astype(val_dtype or np.float32, copy=False),
            lcols=lcols,
            sub_b0=sub_b0.astype(np.int32),
            sub_dlo=sub_dlo.view(np.int32),
            sub_dhi=sub_dhi.view(np.int32),
            bmeta=bmeta,
            out_row=out_row.astype(np.int32),
            m=m,
            n=n,
            nnz=mat.nnz,
            num_chunks=num_chunks,
            rank_nb=rank_nb,
            grp_b0=grp_b0,
            group_code=group_code,
        ))
