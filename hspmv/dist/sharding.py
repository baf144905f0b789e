"""Multi-chip SpMV: row-block sharding over a 1D device mesh.

The reference is strictly single-device (SURVEY.md section 2.5: no MPI/
NCCL anywhere); this subsystem is net-new. On one host the cards are
joined all to all (NVLink), so a 1-D mesh over them is the whole
topology:

  * rows are block-partitioned across the mesh axis "rows" — the
    distributed analog of CSR-k's coarsest level (each device owns a
    contiguous super-block of RCM'd rows),
  * x is row-sharded like y; each device needs a window of x covering
    its columns. After RCM that window is the device's own rows plus a
    narrow band overlap, so the default exchange is a neighbor
    `ppermute` halo (O(bandwidth) bytes per link); matrices whose
    columns reach beyond the neighbor shards fall back to a full
    all-gather automatically (correct for any structure),
  * each device runs the single-card slab SpMV on its block, with
    columns pre-shifted into halo-window coordinates at build time.

Built on shard_map so the collective schedule is explicit and XLA can
overlap it with the local gather set-up.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hspmv.formats.csr import CSRMatrix
from hspmv.formats.sell import LANES, SUBLANES, RankedSlabs, SellSlabs
from hspmv.kernels.sell import spmv_ranked, spmv_sell


def make_row_mesh(devices=None, axis: str = "rows") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def mesh_axis_size(mesh: Mesh, axis) -> int:
    """Total devices under `axis` (a name or tuple of names — the
    multi-host case shards rows over the flattened ("hosts", "rows"))."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    size = 1
    for name in names:
        size *= mesh.shape[name]
    return size


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _slice_shard_blocks(mat: CSRMatrix, n_devices: int, halo: str):
    """Cut rows into n_devices equal blocks (shared by every sharded
    layout class). Returns (blocks, halo_rows, rows_per_shard); blocks'
    columns are pre-shifted into halo-window coordinates when the
    neighbor exchange applies (see ShardedSell docstring)."""
    m, n = mat.shape
    rows_per_shard = _round_up(
        _round_up(m, n_devices) // n_devices, SUBLANES * LANES
    )

    # The exchange carries x as (padded_m,) row-sharded pieces — the
    # all-gather path reconstructs at most rows_per_shard * n_devices
    # columns. A rectangular matrix with n beyond that would have its
    # high columns silently ZEROED (review r5): refuse at build.
    if n > rows_per_shard * n_devices:
        raise ValueError(
            f"distributed layouts carry x in row-sharded (padded_m,) "
            f"pieces; n={n} exceeds padded_m="
            f"{rows_per_shard * n_devices} and the high columns would "
            f"be dropped — shard a square/narrower operator, or add "
            f"devices"
        )

    halo_rows = 0
    if halo != "never" and m == n and n_devices > 1:
        reach = 0
        for d in range(n_devices):
            r0 = min(d * rows_per_shard, m)
            r1 = min((d + 1) * rows_per_shard, m)
            cs = mat.indices[mat.indptr[r0] : mat.indptr[r1]]
            if cs.size:
                reach = max(
                    reach, int(r0 - cs.min()), int(int(cs.max()) + 1 - r1)
                )
        if reach <= rows_per_shard:
            halo_rows = _round_up(max(reach, LANES), LANES)
        elif halo == "always":
            raise ValueError(
                f"halo exchange requested but columns reach {reach} rows "
                f"past the shard (> rows_per_shard={rows_per_shard})"
            )

    blocks = []
    for d in range(n_devices):
        r0 = min(d * rows_per_shard, m)
        r1 = min((d + 1) * rows_per_shard, m)
        sl_indptr = (
            mat.indptr[r0 : r1 + 1].astype(np.int64) - int(mat.indptr[r0])
            if r1 > r0
            else np.zeros(1, dtype=np.int64)
        )
        pad_rows = rows_per_shard - (r1 - r0)
        if pad_rows:
            sl_indptr = np.concatenate(
                [sl_indptr, np.full(pad_rows, sl_indptr[-1], dtype=np.int64)]
            )
        cols_d = mat.indices[mat.indptr[r0] : mat.indptr[r1]].astype(np.int64)
        if halo_rows:
            cols_d = cols_d - (r0 - halo_rows)
        shard_n = rows_per_shard + 2 * halo_rows if halo_rows else n
        blocks.append(
            CSRMatrix(
                sl_indptr.astype(np.int32),
                cols_d.astype(np.int32),
                mat.data[mat.indptr[r0] : mat.indptr[r1]],
                (rows_per_shard, shard_n),
            )
        )
    return blocks, halo_rows, rows_per_shard


def shard_layout(layout, mesh: Mesh, axis="rows"):
    """Place a Sharded* layout's stacked arrays over `axis` (name or
    tuple of names — the multi-host ("hosts", "rows") case).

    Uses make_array_from_callback, which constructs only the process's
    addressable shards, so the same call works single-process (simulated
    meshes, single host) and multi-process (each process holds the full
    host-side layout and contributes its local shards).
    """
    sh = NamedSharding(mesh, P(axis))

    def place(a):
        h = np.asarray(a)
        return jax.make_array_from_callback(h.shape, sh, lambda idx: h[idx])

    return jax.tree_util.tree_map(place, layout)


def shard_vector(vec, mesh: Mesh, axis="rows"):
    """Row-shard a host vector over `axis` (process-safe, as above)."""
    h = np.asarray(vec)
    sh = NamedSharding(mesh, P(axis))
    return jax.make_array_from_callback(h.shape, sh, lambda idx: h[idx])


def _padk(a, target, fill):
    a = np.asarray(a)
    pad = target - a.shape[0]
    if pad == 0:
        return a
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedSell:
    """Per-device SELL layouts stacked on a leading mesh dimension.

    All devices share identical array shapes (padded to the max) so the
    stack shards cleanly over the mesh axis.
    """

    vals: jax.Array  # (D, total_k, 128)
    cols: jax.Array  # (D, total_k, 128) — GLOBAL ids (all-gather mode) or
    #                   halo-window-local ids (halo mode)
    sub_b0: jax.Array  # (D, S)
    sub_nb: jax.Array  # (D, S)
    sub_chunk: jax.Array  # (D, S)
    m: int
    n: int
    nnz: int
    rows_per_shard: int  # padded to a multiple of 8*128
    num_chunks_local: int
    max_nb: int
    n_devices: int
    halo: int = 0  # halo width in rows (0 => all-gather exchange)
    chunk_q: int = 0  # uniform sub-tiles per chunk across shards (0 = ragged)

    def tree_flatten(self):
        children = (self.vals, self.cols, self.sub_b0, self.sub_nb, self.sub_chunk)
        aux = (
            self.m,
            self.n,
            self.nnz,
            self.rows_per_shard,
            self.num_chunks_local,
            self.max_nb,
            self.n_devices,
            self.halo,
            self.chunk_q,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def _local_layout_struct(self, vals, cols, sub_b0, sub_nb, sub_chunk) -> SellSlabs:
        local_n = (
            self.rows_per_shard + 2 * self.halo if self.halo else self.n
        )
        return SellSlabs(
            vals=vals,
            cols=cols,
            sub_b0=sub_b0,
            sub_nb=sub_nb,
            sub_chunk=sub_chunk,
            m=self.rows_per_shard,
            n=local_n,
            nnz=self.nnz,  # only used for stats
            num_chunks=self.num_chunks_local,
            max_nb=self.max_nb,
            chunk_q=self.chunk_q,
        )

    @classmethod
    def build(cls, mat: CSRMatrix, n_devices: int, halo: str = "auto") -> "ShardedSell":
        """Partition rows into n_devices equal blocks and build layouts.

        halo: "auto" uses the neighbor-halo exchange when every shard's
        columns stay within its immediate neighbors (the RCM-banded
        case), falling back to all-gather otherwise; "never" forces
        all-gather; "always" asserts the banded condition.
        """
        m, n = mat.shape
        blocks, halo_rows, rows_per_shard = _slice_shard_blocks(
            mat, n_devices, halo
        )
        shards = [SellSlabs.from_csr(block, on_host=True) for block in blocks]

        # Pad all shards to identical shapes.
        total_k = max(int(s.vals.shape[0]) for s in shards)
        S = max(s.num_subtiles for s in shards)
        num_chunks_local = rows_per_shard // LANES
        max_nb = max(s.max_nb for s in shards)
        padk = _padk

        vals = np.stack([padk(s.vals, total_k, 0.0) for s in shards])
        cols = np.stack([padk(s.cols, total_k, 0) for s in shards])
        sub_b0 = np.stack([padk(s.sub_b0, S, 0) for s in shards])
        sub_nb = np.stack([padk(s.sub_nb, S, 1) for s in shards])
        # Padding sub-tiles point at the dropped segment (num_chunks_local).
        sub_chunk = np.stack(
            [padk(s.sub_chunk, S, num_chunks_local) for s in shards]
        )
        return cls(
            vals=np.asarray(vals),
            cols=np.asarray(cols),
            sub_b0=np.asarray(sub_b0),
            sub_nb=np.asarray(sub_nb),
            sub_chunk=np.asarray(sub_chunk),
            m=m,
            n=n,
            nnz=mat.nnz,
            rows_per_shard=rows_per_shard,
            num_chunks_local=num_chunks_local,
            max_nb=max_nb,
            n_devices=n_devices,
            halo=halo_rows,
            # Shards were padded to common shapes, so per-shard uniformity
            # only survives if every shard agrees (incl. the sub-tile pad).
            chunk_q=(
                shards[0].chunk_q
                if all(
                    s.chunk_q == shards[0].chunk_q
                    and s.num_subtiles == S
                    and s.num_chunks == num_chunks_local
                    for s in shards
                )
                else 0
            ),
        )

    def device_put(self, mesh: Mesh, axis="rows") -> "ShardedSell":
        """Place the stacked arrays with the leading dim sharded over
        `axis` (name or tuple; process-safe via shard_layout)."""
        return shard_layout(self, mesh, axis)

    @property
    def padded_m(self) -> int:
        return self.rows_per_shard * self.n_devices


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedRanked:
    """Per-device rank-windowed layouts stacked on a leading mesh dim.

    The distributed flagship: each shard runs the single-card ranked
    SpMV (aligned or column-binned windows) after the same
    halo/all-gather x exchange as ShardedSell. Shard arrays are padded
    to common shapes; rank_nb is the max over shards.
    """

    vals: jax.Array  # (D, total_k, 128)
    lcols: jax.Array  # (D, total_k, 128) window-local columns
    sub_b0: jax.Array  # (D, S)
    sub_dlo: jax.Array  # (D, S)
    sub_dhi: jax.Array  # (D, S)
    sub_chunk: jax.Array  # (D, S)
    m: int
    n: int
    nnz: int
    rows_per_shard: int
    num_chunks_local: int
    rank_nb: int
    n_devices: int
    halo: int = 0
    chunk_q: int = 0
    # Shared grouped windows (one static group partition across ALL
    # shards — see build); grp_b0 is (D, S*G) sub-tile-major like the
    # single-chip layout, group_code == 0 disables grouping.
    grp_b0: jax.Array = None
    group_code: int = 0
    # Per-shard x length the local kernel sees; 0 derives the historical
    # value (rows_per_shard + 2*halo with a halo, else n). The overlap
    # split (build_overlap) sets it explicitly: the main stack consumes
    # exactly x_shard (rows_per_shard) and the edge stack exactly the
    # 2*halo exchanged rows.
    local_n: int = 0

    def tree_flatten(self):
        children = (
            self.vals, self.lcols, self.sub_b0, self.sub_dlo, self.sub_dhi,
            self.sub_chunk, self.grp_b0,
        )
        aux = (
            self.m, self.n, self.nnz, self.rows_per_shard,
            self.num_chunks_local, self.rank_nb, self.n_devices, self.halo,
            self.chunk_q, self.group_code, self.local_n,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:6], *aux[:9], grp_b0=children[6],
                   group_code=aux[9], local_n=aux[10])

    def _local_layout_struct(
        self, vals, lcols, sub_b0, sub_dlo, sub_dhi, sub_chunk, grp_b0,
    ) -> RankedSlabs:
        local_n = self.local_n or (
            self.rows_per_shard + 2 * self.halo if self.halo else self.n
        )
        return RankedSlabs(
            vals=vals,
            lcols=lcols,
            sub_b0=sub_b0,
            sub_dlo=sub_dlo,
            sub_dhi=sub_dhi,
            sub_chunk=sub_chunk,
            m=self.rows_per_shard,
            n=local_n,
            nnz=self.nnz,  # only used for stats
            num_chunks=self.num_chunks_local,
            rank_nb=self.rank_nb,
            chunk_q=self.chunk_q,
            grp_b0=grp_b0,
            group_code=self.group_code,
        )

    @classmethod
    def build(
        cls, mat: CSRMatrix, n_devices: int, halo: str = "auto",
        bin_blocks: int = 0, val_dtype=None,
    ) -> "ShardedRanked":
        """val_dtype: per-shard slab value storage (default float32);
        jnp.bfloat16 halves the dominant value traffic on every shard —
        see RankedSlabs.from_csr for the accuracy contract."""
        m, n = mat.shape
        blocks, halo_rows, rows_per_shard = _slice_shard_blocks(
            mat, n_devices, halo
        )
        return cls._from_blocks(
            blocks, m=m, n=n, nnz=mat.nnz, rows_per_shard=rows_per_shard,
            halo_rows=halo_rows, bin_blocks=bin_blocks, val_dtype=val_dtype,
        )

    @classmethod
    def _from_blocks(
        cls, blocks, *, m, n, nnz, rows_per_shard, halo_rows,
        bin_blocks=0, val_dtype=None, local_n=0, allow_groups=True,
    ) -> "ShardedRanked":
        n_devices = len(blocks)
        # Grouped windows across shards: every shard must share ONE
        # static group map, so shard 0's greedy partition becomes
        # the global group_plan and the other shards are built against
        # it (RankedSlabs.from_csr validates the read-extent budget).
        # Any shard that cannot honor the plan drops the whole stack to
        # the packed-delta encoding (shard-uniform by construction).
        shards = [
            RankedSlabs.from_csr(
                blocks[0], bin_blocks=bin_blocks,
                allow_groups=allow_groups, val_dtype=val_dtype, on_host=True,
            )
        ]
        plan = shards[0].group_members if shards[0].group_code else None
        # Budget from the planning shard's window extent: the stacked
        # product runs at the max rank over shards, so siblings validate
        # against shard 0's budget, not their own (a tail shard's locally
        # narrower rank must not reject the plan).
        r0 = shards[0].rank_nb
        budget = 1 if r0 == 1 else 2 * max((r0 + 1) // 2, 1)
        try:
            for block in blocks[1:]:
                shards.append(
                    RankedSlabs.from_csr(
                        block, bin_blocks=bin_blocks,
                        allow_groups=False, group_plan=plan,
                        group_plan_budget=budget, val_dtype=val_dtype,
                        on_host=True,
                    )
                )
        except ValueError:
            shards = [
                RankedSlabs.from_csr(
                    block, bin_blocks=bin_blocks, allow_groups=False,
                    val_dtype=val_dtype, on_host=True,
                )
                for block in blocks
            ]

        total_k = max(int(s.vals.shape[0]) for s in shards)
        S = max(s.num_subtiles for s in shards)
        num_chunks_local = rows_per_shard // LANES
        rank_nb = max(s.rank_nb for s in shards)
        # Widest shard dtype wins (shards narrow independently: uint8 at
        # rank<=2, int16 below 2^15 — formats/sell.py).
        dts = [np.asarray(s.lcols).dtype for s in shards]
        lcol_dtype = (
            np.int32 if np.int32 in dts
            else np.int16 if np.int16 in dts
            else np.uint8
        )
        padk = _padk

        vals = np.stack([padk(s.vals, total_k, 0.0) for s in shards])
        # Padding lcols of 0 gather the window base (val=0 keeps it inert).
        lcols = np.stack(
            [padk(np.asarray(s.lcols).astype(lcol_dtype), total_k, 0)
             for s in shards]
        )
        sub_b0 = np.stack([padk(s.sub_b0, S, 0) for s in shards])
        sub_dlo = np.stack([padk(s.sub_dlo, S, 0) for s in shards])
        sub_dhi = np.stack([padk(s.sub_dhi, S, 0) for s in shards])
        sub_chunk = np.stack(
            [padk(s.sub_chunk, S, num_chunks_local) for s in shards]
        )
        group_code = shards[0].group_code
        if group_code:
            # (S, G) sub-tile-major per shard; padding sub-tiles read
            # block 0 (in-bounds, vals are 0 -> inert).
            G = max(shards[0].groups) + 1
            grp_b0 = np.stack([
                padk(np.asarray(s.grp_b0).reshape(-1, G), S, 0).reshape(-1)
                for s in shards
            ])
        else:
            grp_b0 = np.zeros((len(shards), 0), np.int32)
        return cls(
            vals=np.asarray(vals),
            lcols=np.asarray(lcols),
            sub_b0=np.asarray(sub_b0),
            sub_dlo=np.asarray(sub_dlo),
            sub_dhi=np.asarray(sub_dhi),
            sub_chunk=np.asarray(sub_chunk),
            m=m,
            n=n,
            nnz=nnz,
            rows_per_shard=rows_per_shard,
            num_chunks_local=num_chunks_local,
            rank_nb=rank_nb,
            n_devices=n_devices,
            halo=halo_rows,
            chunk_q=(
                shards[0].chunk_q
                if all(
                    s.chunk_q == shards[0].chunk_q
                    and s.num_subtiles == S
                    and s.num_chunks == num_chunks_local
                    for s in shards
                )
                else 0
            ),
            grp_b0=np.asarray(grp_b0),
            group_code=group_code,
            local_n=local_n,
        )

    def device_put(self, mesh: Mesh, axis="rows") -> "ShardedRanked":
        return shard_layout(self, mesh, axis)

    @property
    def padded_m(self) -> int:
        return self.rows_per_shard * self.n_devices


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class OverlapRanked:
    """Communication/compute-overlapped distributed flagship.

    spmv_sharded's local kernel consumes the halo-extended x, so the
    neighbor ppermute must land before the local SpMV starts — the
    exchange sits on the critical path. This split removes the
    dependency: every nonzero is owned by exactly one of two stacks,

      main: columns inside the owning shard's own rows — consumes
            x_shard DIRECTLY (no exchange);
      edge: columns in a neighbor's rows (at most `halo` past either
            boundary by construction) — consumes ONLY the 2*halo
            exchanged rows.

    y = main(x_shard) + edge(concat(from_left, from_right)): the main
    kernel has no data dependency on the ppermutes, so XLA's
    latency-hiding scheduler can overlap the halo exchange with the bulk
    of the SpMV; only the small edge kernel (band-boundary nonzeros)
    waits on the link. The reference has no analog (nothing crosses a
    process boundary there, SURVEY.md §2.5); this is SURVEY §7's "halo
    overlap" hard part, solved by entry splitting rather than double
    buffering.

    f32 note: the split changes the accumulation ORDER for boundary
    rows (edge contributions are added after the main dot) — a ~1-ulp
    effect, inside the 1e-6 rel-L2 test bar.
    """

    main: ShardedRanked
    edge: ShardedRanked

    def tree_flatten(self):
        return (self.main, self.edge), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        return cls(*children)

    @property
    def halo(self) -> int:
        return self.main.halo

    @property
    def n_devices(self) -> int:
        return self.main.n_devices

    @property
    def rows_per_shard(self) -> int:
        return self.main.rows_per_shard

    @property
    def padded_m(self) -> int:
        return self.main.padded_m

    @property
    def m(self) -> int:
        return self.main.m

    @property
    def n(self) -> int:
        return self.main.n

    @property
    def nnz(self) -> int:
        return self.main.nnz + self.edge.nnz

    def device_put(self, mesh: Mesh, axis="rows") -> "OverlapRanked":
        return OverlapRanked(
            main=self.main.device_put(mesh, axis),
            edge=self.edge.device_put(mesh, axis),
        )

    @classmethod
    def build(
        cls, mat: CSRMatrix, n_devices: int, bin_blocks: int = 0,
        val_dtype=None,
    ) -> "OverlapRanked":
        """Raises ValueError when the banded halo exchange does not
        apply (the split is meaningless under all-gather — callers fall
        back to ShardedRanked there)."""
        m, n = mat.shape
        blocks, halo_rows, rows_per_shard = _slice_shard_blocks(
            mat, n_devices, "always"
        )
        if halo_rows == 0:
            # "always" raises only for over-wide square coupling;
            # rectangular matrices and n_devices == 1 fall through with
            # halo 0, where the interior/edge split is meaningless (the
            # interior mask would misread GLOBAL columns as shard-local).
            raise ValueError(
                "overlap split needs the banded neighbor halo (square "
                f"matrix, >1 device); got shape {mat.shape}, "
                f"n_devices={n_devices}"
            )
        H = halo_rows
        rows_cache = {}

        def split(blk, mask, width, shift):
            key = id(blk)
            if key not in rows_cache:
                rows_cache[key] = np.repeat(
                    np.arange(blk.m, dtype=np.int64), blk.row_lengths
                )
            rows = rows_cache[key]
            ip = np.zeros(blk.m + 1, np.int64)
            np.add.at(ip, rows[mask] + 1, 1)
            np.cumsum(ip, out=ip)
            return CSRMatrix(
                ip.astype(np.int32),
                shift(blk.indices[mask].astype(np.int64)).astype(np.int32),
                blk.data[mask],
                (blk.m, width),
            )

        main_blocks, edge_blocks, edge_nnz = [], [], 0
        for blk in blocks:
            cols = blk.indices.astype(np.int64)
            interior = (cols >= H) & (cols < H + rows_per_shard)
            main_blocks.append(
                split(blk, interior, rows_per_shard, lambda c: c - H)
            )
            edge_nnz += int((~interior).sum())
            edge_blocks.append(
                split(
                    blk, ~interior, 2 * H,
                    lambda c: np.where(c < H, c, c - rows_per_shard),
                )
            )
        main = ShardedRanked._from_blocks(
            main_blocks, m=m, n=n, nnz=mat.nnz - edge_nnz,
            rows_per_shard=rows_per_shard, halo_rows=H,
            bin_blocks=bin_blocks, val_dtype=val_dtype,
            local_n=rows_per_shard,
        )
        edge = ShardedRanked._from_blocks(
            edge_blocks, m=m, n=n, nnz=edge_nnz,
            rows_per_shard=rows_per_shard, halo_rows=H,
            val_dtype=val_dtype, local_n=2 * H, allow_groups=False,
        )
        return cls(main=main, edge=edge)


def spmv_overlap(
    layout: OverlapRanked,
    x: jax.Array,
    mesh: Mesh,
    axis="rows",
):
    """y = A @ x with the halo exchange overlapped behind the main
    kernel (see OverlapRanked). Same calling convention as
    spmv_sharded: x (padded_m[, B]) row-sharded P(axis), axis may be a
    tuple for the multi-host hybrid mesh.

    Each shard issues the halo ppermutes first (nothing in the main
    kernel depends on them, so the scheduler keeps them in flight), runs
    the interior stack on x_shard, then adds the edge stack over the
    exchanged 2*halo rows."""
    D = layout.n_devices
    D_mesh = mesh_axis_size(mesh, axis)
    if D_mesh != D:
        raise ValueError(
            f"layout was built for {D} shards but axis {axis!r} spans "
            f"{D_mesh} devices"
        )
    H = layout.halo
    main, edge = layout.main, layout.edge

    def local(mv, ml, mb0, mdlo, mdhi, mchunk, mgrp,
              ev, el, eb0, edlo, edhi, echunk, egrp, x_shard):
        from_left = jax.lax.ppermute(
            x_shard[-H:], axis, [(i, i + 1) for i in range(D - 1)]
        )
        from_right = jax.lax.ppermute(
            x_shard[:H], axis, [(i + 1, i) for i in range(D - 1)]
        )
        main_local = main._local_layout_struct(
            mv[0], ml[0], mb0[0], mdlo[0], mdhi[0], mchunk[0], mgrp[0],
        )
        y = spmv_ranked(main_local, x_shard)
        edge_local = edge._local_layout_struct(
            ev[0], el[0], eb0[0], edlo[0], edhi[0], echunk[0], egrp[0],
        )
        y = y + spmv_ranked(
            edge_local, jnp.concatenate([from_left, from_right])
        )
        return y[None]

    operands = (
        main.vals, main.lcols, main.sub_b0, main.sub_dlo, main.sub_dhi,
        main.sub_chunk, main.grp_b0,
        edge.vals, edge.lcols, edge.sub_b0, edge.sub_dlo, edge.sub_dhi,
        edge.sub_chunk, edge.grp_b0,
        x,
    )
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * len(operands),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(*operands).reshape(-1, *x.shape[1:])


def _exchange_x(layout, x_shard, axis):
    """Collect each shard's x window: neighbor ppermute halo when the
    structure allows, tiled all-gather otherwise (see module docstring).

    axis may be a tuple of mesh axis names — JAX collectives treat it as
    one flattened logical axis (row-major over the tuple), so the same
    neighbor pairs cross the process boundary in a ("hosts", "rows")
    mesh; only the two boundary shards of each process put halo bytes
    on the inter-host network."""
    D = layout.n_devices
    H = layout.halo
    if H:
        from_left = jax.lax.ppermute(
            x_shard[-H:], axis, [(i, i + 1) for i in range(D - 1)]
        )
        from_right = jax.lax.ppermute(
            x_shard[:H], axis, [(i + 1, i) for i in range(D - 1)]
        )
        return jnp.concatenate([from_left, x_shard, from_right])
    return jax.lax.all_gather(x_shard, axis, tiled=True)[: layout.n]


def spmv_sharded(
    layout,
    x: jax.Array,
    mesh: Mesh,
    axis="rows",
):
    """y = A @ x, rows sharded over `axis`; x arrives row-sharded.

    layout: ShardedSell or ShardedRanked (the flagship).
    x: (padded_m,) float32 sharded P(axis) (square matrices: padded with
    zeros beyond n). Returns y (padded_m,) sharded P(axis). An x of
    shape (padded_m, B) gives the SpMM Y (padded_m, B): the halo
    exchange then moves (H, B) edge blocks over the same pairs.
    axis: mesh axis name, or a TUPLE of names for the multi-process
    mesh (rows sharded over the flattened ("hosts", "rows")). The layout
    must have been built with n_devices == the product of the named
    axis sizes.
    """
    D_mesh = mesh_axis_size(mesh, axis)
    if D_mesh != layout.n_devices:
        raise ValueError(
            f"layout was built for {layout.n_devices} shards but axis "
            f"{axis!r} spans {D_mesh} devices"
        )

    if isinstance(layout, ShardedRanked):

        def local(vals, lcols, sub_b0, sub_dlo, sub_dhi, sub_chunk,
                  grp_b0, x_shard):
            x_in = _exchange_x(layout, x_shard, axis)
            local_layout = layout._local_layout_struct(
                vals[0], lcols[0], sub_b0[0], sub_dlo[0], sub_dhi[0],
                sub_chunk[0], grp_b0[0],
            )
            return spmv_ranked(local_layout, x_in)[None]

        operands = (
            layout.vals, layout.lcols, layout.sub_b0, layout.sub_dlo,
            layout.sub_dhi, layout.sub_chunk, layout.grp_b0, x,
        )
    else:

        def local(vals, cols, sub_b0, sub_nb, sub_chunk, x_shard):
            x_in = _exchange_x(layout, x_shard, axis)
            local_layout = layout._local_layout_struct(
                vals[0], cols[0], sub_b0[0], sub_nb[0], sub_chunk[0]
            )
            return spmv_sell(local_layout, x_in)[None]

        operands = (
            layout.vals, layout.cols, layout.sub_b0, layout.sub_nb,
            layout.sub_chunk, x,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * len(operands),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(*operands).reshape(-1, *x.shape[1:])
