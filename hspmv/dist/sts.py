"""Distributed lower-triangular solve: block back-substitution over a
device mesh.

The reference's STS is strictly single-process (OpenMP barriers between
packs, spmv-csrk/csrk.cpp:79-145); this subsystem is net-new. The
schedule is the classic block forward-substitution over D row shards of
the pack-padded strict-L system (sts/solve.py):

    for d in 0..D-1:                       # sequential chain
        x_d = solve(L_dd, b_d - L_d,<d @ x_<d)

  * the GLOBAL pack-padded strict-L (rows already dependency-ordered by
    sts/host.build_sts) is row-partitioned on 8*128-aligned boundaries,
    so solve chunks never straddle shards and each shard's diagonal
    block runs the single-card level-scheduled solve
    (sts/solve.lower_solve_blocks) over its part of the packs,
  * L_dd (columns inside the shard) solves locally; L_d,<d (columns in
    earlier shards) is a plain SELL SpMV whose values are pre-scaled by
    inv_diag at build, so the rhs correction is one fused subtract,
  * dependencies cross shards arbitrarily (level-set permutations spray
    a row's parents over all earlier packs), so the exchange is an
    all-gather of x per step — correct for any structure. (A banded
    non-pack-permuted system could ride the neighbor halo instead;
    measure before specializing.)

Every device executes every step and a `where` keeps only the owner's
result: wall-clock equals the D-step dependency chain either way (the
chain is inherent to triangular solves — the reference pays the same
serialization as its pack barrier), and redundant compute keeps the
program SPMD with zero control-flow divergence.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from hspmv.formats.csr import CSRMatrix
from hspmv.formats.sell import LANES, SUBLANES, SellSlabs
from hspmv.dist.sharding import _padk, mesh_axis_size, shard_layout
from hspmv.sts.host import TriangularSystem
from hspmv.sts.solve import (
    LevelSchedule, _round_up, chunk_packs, choose_step, lower_solve_blocks,
    pack_padding, stack_schedules,
)


def _sell_children(s: SellSlabs):
    return s.vals, s.cols, s.sub_b0, s.sub_nb, s.sub_chunk


def _stack_sell(shards, num_chunks_local):
    """Stack per-shard SellSlabs leaves to identical shapes."""
    total_k = max(int(s.vals.shape[0]) for s in shards)
    S = max(s.num_subtiles for s in shards)
    out = []
    for i, fill in enumerate((0.0, 0, 0, 1, num_chunks_local)):
        out.append(
            np.stack([
                _padk(np.asarray(_sell_children(s)[i]), total_k if i < 2 else S,
                      fill)
                for s in shards
            ])
        )
    return out, max(s.max_nb for s in shards)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedLowerSolve:
    """Per-shard diag-solve + off-diag-SpMV layouts stacked on a leading
    mesh dimension (see module docstring)."""

    # Diagonal block: strict-L columns inside the shard (local coords).
    dvals: jax.Array
    dcols: jax.Array
    dsub_b0: jax.Array
    dsub_nb: jax.Array
    dsub_chunk: jax.Array
    dsched: LevelSchedule  # per-shard solve steps, stacked
    # Off-diagonal block: columns in earlier shards (global padded
    # coords), values pre-scaled by the owning row's inv_diag.
    ovals: jax.Array
    ocols: jax.Array
    osub_b0: jax.Array
    osub_nb: jax.Array
    osub_chunk: jax.Array
    b_scale: jax.Array  # (D, num_chunks_local + 1, 128)
    # inv_diag in the same padded blocks: lets sts_solve_sharded take a
    # fresh rhs per call (the preconditioner path solves a new r every
    # CG iteration) instead of the build-time baked b.
    inv_diag: jax.Array  # (D, num_chunks_local + 1, 128)
    m: int
    padded_m: int
    rows_per_shard: int
    num_chunks_local: int
    d_max_nb: int
    o_max_nb: int
    n_devices: int

    def tree_flatten(self):
        children = (
            self.dvals, self.dcols, self.dsub_b0, self.dsub_nb,
            self.dsub_chunk, self.dsched, self.ovals, self.ocols, self.osub_b0,
            self.osub_nb, self.osub_chunk, self.b_scale, self.inv_diag,
        )
        aux = (
            self.m, self.padded_m, self.rows_per_shard,
            self.num_chunks_local, self.d_max_nb, self.o_max_nb,
            self.n_devices,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def device_put(self, mesh: Mesh, axis="rows") -> "ShardedLowerSolve":
        return shard_layout(self, mesh, axis)

    @classmethod
    def build(
        cls, sys: TriangularSystem, b: np.ndarray, n_devices: int,
    ) -> tuple["ShardedLowerSolve", np.ndarray]:
        """Returns (layout, pad_index). pad_index maps the system's
        permuted rows into the flattened (padded_m,) solution the solve
        returns — apply on the host after solve()."""
        L = sys.lower
        m = L.m
        lens = L.row_lengths
        if not np.all(lens >= 1):
            raise ValueError("lower factor has an empty row")
        diag_pos = L.indptr[1:].astype(np.int64) - 1
        diag = L.data[diag_pos]
        if np.any(diag == 0.0):
            raise ValueError("zero diagonal entry; system is singular")
        inv_diag = (1.0 / diag).astype(np.float32)

        # Global pack padding (identical to LowerSolveLayout.build).
        pad_index, pad_start = pack_padding(sys)
        m_pad = int(pad_start[-1])

        # Shard boundaries on whole solve chunks (8*128 rows).
        rows_per_shard = _round_up(
            _round_up(m_pad, n_devices) // n_devices, SUBLANES * LANES
        )
        padded_m = rows_per_shard * n_devices
        num_chunks_local = rows_per_shard // LANES

        # Strict lower in padded coords; b scaled by inv_diag. Padding
        # rows have no entries and b = 0, so they solve to x = 0.
        keep = np.ones(L.nnz, dtype=bool)
        keep[diag_pos] = False
        rows_p = pad_index[
            np.repeat(np.arange(m, dtype=np.int64), lens)[keep]
        ]
        cols_p = pad_index[L.indices[keep].astype(np.int64)]
        vals = (
            L.data[keep].astype(np.float64)
            * inv_diag[np.repeat(np.arange(m, dtype=np.int64), lens)[keep]]
        ).astype(np.float32)
        b_pad = np.zeros(padded_m, np.float32)
        b_pad[pad_index] = np.asarray(b, np.float64) * inv_diag

        # (rows_p, cols_p) are already row-major with ascending
        # columns: np.repeat keeps row order, pad_index is strictly
        # increasing, and CSR row columns ascend — same invariant
        # sts/solve.py relies on without sorting (review r5 removed a
        # redundant O(nnz log nnz) argsort here).

        d_shards, o_shards = [], []
        for d in range(n_devices):
            r0, r1 = d * rows_per_shard, (d + 1) * rows_per_shard
            sel = (rows_p >= r0) & (rows_p < r1)
            rd, cd, vd = rows_p[sel] - r0, cols_p[sel], vals[sel]
            in_diag = cd >= r0
            if not np.all(cd < r1):
                raise ValueError("strict-L entry above the diagonal block")

            def block(rows_b, cols_b, vals_b, n_cols):
                indptr = np.zeros(rows_per_shard + 1, np.int64)
                np.add.at(indptr, rows_b + 1, 1)
                np.cumsum(indptr, out=indptr)
                return CSRMatrix(
                    indptr.astype(np.int32),
                    cols_b.astype(np.int32),
                    vals_b.astype(np.float32),
                    (rows_per_shard, n_cols),
                )

            d_shards.append(SellSlabs.from_csr(block(
                rd[in_diag], cd[in_diag] - r0, vd[in_diag], rows_per_shard
            ), on_host=True))
            o_shards.append(SellSlabs.from_csr(block(
                rd[~in_diag], cd[~in_diag], vd[~in_diag], padded_m
            ), on_host=True))

        (dv, dc, db0, dnb, dch), d_max_nb = _stack_sell(
            d_shards, num_chunks_local
        )
        # One step size for every shard (the stacked program is shared).
        packs = [
            chunk_packs(pad_start, num_chunks_local, d * num_chunks_local)
            for d in range(n_devices)
        ]
        T = choose_step(
            np.concatenate([
                LevelSchedule.pack_subtiles(s.sub_chunk, cp)
                for s, cp in zip(d_shards, packs)
            ]),
            max(int(np.bincount(
                np.asarray(s.sub_chunk)[np.asarray(s.sub_chunk) < num_chunks_local]
            ).max(initial=1)) for s in d_shards),
        )
        dsched = stack_schedules(
            [LevelSchedule.build(s.sub_chunk, cp, T, on_host=True)
             for s, cp in zip(d_shards, packs)],
            dv.shape[1] // SUBLANES, num_chunks_local,
        )
        (ov, oc, ob0, onb, och), o_max_nb = _stack_sell(
            o_shards, num_chunks_local
        )
        b_blocks = np.zeros(
            (n_devices, num_chunks_local + 1, LANES), np.float32
        )
        b_blocks[:, :num_chunks_local] = b_pad.reshape(
            n_devices, num_chunks_local, LANES
        )
        inv_pad = np.zeros(padded_m, np.float32)
        inv_pad[pad_index] = inv_diag
        inv_blocks = np.zeros_like(b_blocks)
        inv_blocks[:, :num_chunks_local] = inv_pad.reshape(
            n_devices, num_chunks_local, LANES
        )
        jnp_ = np.asarray  # host arrays: device_put places each shard
        return cls(
            dvals=jnp_(dv), dcols=jnp_(dc), dsub_b0=jnp_(db0),
            dsub_nb=jnp_(dnb), dsub_chunk=jnp_(dch), dsched=dsched,
            ovals=jnp_(ov), ocols=jnp_(oc), osub_b0=jnp_(ob0),
            osub_nb=jnp_(onb), osub_chunk=jnp_(och),
            b_scale=jnp_(b_blocks),
            inv_diag=jnp_(inv_blocks),
            m=m, padded_m=padded_m, rows_per_shard=rows_per_shard,
            num_chunks_local=num_chunks_local, d_max_nb=d_max_nb,
            o_max_nb=o_max_nb, n_devices=n_devices,
        ), pad_index


def sts_solve_sharded(
    layout: ShardedLowerSolve,
    mesh: Mesh,
    axis="rows",
    b: jax.Array | None = None,
) -> jax.Array:
    """Solve L x = b over the mesh; returns x (padded_m,) sharded
    P(axis). Host-side: x_rows = np.asarray(x)[pad_index].

    b: optional fresh rhs (padded_m,), UNSCALED, in the padded system
    coordinates (scatter through pad_index first) — overrides the
    build-time baked b_scale; the preconditioner path solves a new
    residual every CG iteration."""
    from hspmv.kernels.sell import spmv_sell

    D = layout.n_devices
    if mesh_axis_size(mesh, axis) != D:
        raise ValueError(
            f"layout was built for {D} shards but axis {axis!r} spans "
            f"{mesh_axis_size(mesh, axis)} devices"
        )
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    nc = layout.num_chunks_local

    def local(dv, dc, db0, dnb, dch, ds0, dc0, dnc, dstep, ov, oc, ob0,
              onb, och, bsc, invd, *maybe_b):
        diag = SellSlabs(
            vals=dv[0], cols=dc[0], sub_b0=db0[0], sub_nb=dnb[0],
            sub_chunk=dch[0], m=layout.rows_per_shard,
            n=layout.rows_per_shard, nnz=0, num_chunks=nc,
            max_nb=layout.d_max_nb, chunk_q=0,
        )
        sched = LevelSchedule(ds0[0], dc0[0], dnc[0], dstep[0], layout.dsched.T)
        off = SellSlabs(
            vals=ov[0], cols=oc[0], sub_b0=ob0[0], sub_nb=onb[0],
            sub_chunk=och[0], m=layout.rows_per_shard, n=layout.padded_m,
            nnz=0, num_chunks=nc, max_nb=layout.o_max_nb, chunk_q=0,
        )
        if maybe_b:
            b_sc = jnp.concatenate([
                maybe_b[0].reshape(nc, LANES) * invd[0][:nc],
                jnp.zeros((1, LANES), jnp.float32),
            ])
        else:
            b_sc = bsc[0]

        idx = jnp.zeros((), jnp.int32)
        for name in names:
            idx = idx * mesh.shape[name] + jax.lax.axis_index(name)

        def step(k, x_shard):
            xg = jax.lax.all_gather(x_shard, names, tiled=True)
            corr = spmv_sell(off, xg)
            corr_b = jnp.concatenate(
                [corr.reshape(nc, LANES), jnp.zeros((1, LANES), jnp.float32)]
            )
            cand = lower_solve_blocks(diag, sched, b_sc - corr_b)[:-1].reshape(-1)
            return jnp.where(idx == k, cand, x_shard)

        x = jax.lax.fori_loop(
            0, D, step, jnp.zeros((layout.rows_per_shard,), jnp.float32)
        )
        return x[None]

    operands = (
        layout.dvals, layout.dcols, layout.dsub_b0, layout.dsub_nb,
        layout.dsub_chunk, *layout.dsched.tree_flatten()[0],
        layout.ovals, layout.ocols, layout.osub_b0, layout.osub_nb, layout.osub_chunk, layout.b_scale,
        layout.inv_diag,
    ) + ((b,) if b is not None else ())
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * len(operands),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(*operands).reshape(-1)
