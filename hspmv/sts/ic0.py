"""IC(0)-preconditioned CG: the triangular-solve kernels in production.

The reference's `incomplete_choloskey` (csrk.cpp:708-789) splits the
nonzero STRUCTURE only and its STS driver is disabled; this module adds
the numeric incomplete Cholesky factorization IC(0) (values on the
lower-triangular pattern, no fill) and applies M^-1 = (L L^T)^-1 inside
a fully jitted PCG loop — each application is one forward solve on L
and one backward solve on L^T, both running the level-scheduled solve
(sts/solve.py). This is the workload the STS subsystem
exists for: two triangular solves per CG iteration, on device, with no
host round trips inside the loop.

Factorization runs in the native core (cpp/reorder.cc hspmv_ic0,
O(sum of row-length^2) two-pointer row dots) with an exact-parity NumPy
fallback. The backward solve reuses the row+column reversal
(sts/host.reversed_for_upper); both solve systems are built with the LS
order and sort_packs=False, which provably preserves a triangular
input's structure (tests/test_sts.py::test_upper_solve_scipy_parity).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.csr import CSRMatrix
from hspmv.sts.host import build_sts, reversed_for_upper, split_lu
from hspmv.sts.solve import LowerSolveLayout, lower_solve

_HI = jax.lax.Precision.HIGHEST


def _dot(a, b):
    """f32 inner product at full precision."""
    return jnp.vdot(a, b, precision=_HI)


def _ic0_numpy(indptr, indices, data):
    """NumPy IC(0), exact-parity with cpp/reorder.cc hspmv_ic0
    (f32 storage, f64 accumulation, same breakdown shift)."""
    m = indptr.shape[0] - 1
    out = np.array(data, dtype=np.float32, copy=True)
    bad = 0
    for i in range(m):
        i0, i1 = int(indptr[i]), int(indptr[i + 1])
        if i1 <= i0 or indices[i1 - 1] != i:
            raise ValueError(f"row {i}: diagonal must be the last entry")
        for idx in range(i0, i1 - 1):
            k = int(indices[idx])
            s = float(out[idx])
            a, b = i0, int(indptr[k])
            aend, bend = idx, int(indptr[k + 1]) - 1
            while a < aend and b < bend:
                ca, cb = indices[a], indices[b]
                if ca == cb:
                    s -= float(out[a]) * float(out[b])
                    a += 1
                    b += 1
                elif ca < cb:
                    a += 1
                else:
                    b += 1
            out[idx] = np.float32(s / float(out[indptr[k + 1] - 1]))
        s = float(out[i1 - 1])
        for idx in range(i0, i1 - 1):
            s -= float(out[idx]) ** 2
        if not s > 0.0:
            floor_ = max(1e-8 * abs(float(out[i1 - 1])), 1e-8)
            s = max(abs(s), floor_)
            bad += 1
        out[i1 - 1] = np.float32(np.sqrt(s))
    return out, bad


def ic0_factor(mat: CSRMatrix) -> tuple[CSRMatrix, int]:
    """IC(0) factor L (lower, diagonal included) of a symmetric
    positive-definite matrix, on the lower pattern of `mat`. Returns
    (L, breakdown count — 0 for diagonally dominant SPD inputs)."""
    lower, _ = split_lu(mat)
    from hspmv.reorder import native

    if native.available():
        # A native failure here is a real error (malformed structure),
        # not a cue to silently crawl through the pure-Python loop.
        vals, bad = native.ic0(lower.indptr, lower.indices, lower.data)
    else:
        vals, bad = _ic0_numpy(lower.indptr, lower.indices, lower.data)
    return CSRMatrix(lower.indptr, lower.indices, vals, lower.shape), bad


def _build_ic0_systems(mat: CSRMatrix):
    """Factor + the two solve systems both preconditioners share.

    Returns (L, breakdowns, sys_l, inv_l, rev, sys_u, inv_u). Both
    systems use LS order with sort_packs=False — the combination that
    provably preserves a triangular input's structure (build_sts splits
    AFTER permuting; see tests/test_sts.py::test_upper_solve_scipy_
    parity) — and the composed index maps downstream depend on exactly
    these invariants."""
    import scipy.sparse as sp

    L, bad = ic0_factor(mat)
    sys_l = build_sts(L, order_type="LS", sort_packs=False)
    if sys_l.lower.nnz != L.nnz:
        # nnz leaked to the upper split: the schedule did NOT preserve
        # L's triangular structure — the preconditioner would silently
        # solve a different operator (raise, never assert: -O strips
        # asserts and this guards correctness, review r5).
        raise ValueError("LS schedule failed to preserve L's structure")
    inv_l = np.argsort(sys_l.perm)

    U = CSRMatrix.from_scipy(sp.csr_matrix(L.to_scipy().T))
    mat_ru, rev = reversed_for_upper(U)
    sys_u = build_sts(mat_ru, order_type="LS", sort_packs=False)
    if sys_u.lower.nnz != U.nnz:
        raise ValueError("LS schedule failed to preserve U's structure")
    inv_u = np.argsort(sys_u.perm)
    return L, bad, sys_l, inv_l, rev, sys_u, inv_u


def _scatter_b(layout: LowerSolveLayout, b: jax.Array) -> jax.Array:
    """b (m,) in the layout's system order -> scaled padded blocks."""
    flat = jnp.zeros(layout.inv_diag.size, jnp.float32).at[
        layout.pad_index
    ].set(b)
    return flat.reshape(layout.inv_diag.shape) * layout.inv_diag


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class IC0Preconditioner:
    """Jit-ready application of M^-1 = (L L^T)^-1.

    lay_l / lay_u: level-scheduled solve layouts for L and for the
    reversed L^T (a lower system again — sts/host.reversed_for_upper).
    idx0/idx1/idx2: composed gather maps threading the two systems'
    permutations: r -> b_L, y_sys -> b_U, x_sys -> z.
    """

    lay_l: LowerSolveLayout
    lay_u: LowerSolveLayout
    idx0: jax.Array
    idx1: jax.Array
    idx2: jax.Array
    breakdowns: int = 0

    def tree_flatten(self):
        return (
            (self.lay_l, self.lay_u, self.idx0, self.idx1, self.idx2),
            (self.breakdowns,),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def build(cls, mat: CSRMatrix) -> "IC0Preconditioner":
        L, bad, sys_l, inv_l, rev, sys_u, inv_u = _build_ic0_systems(mat)
        b_dummy = np.zeros(L.m, np.float32)
        lay_l = LowerSolveLayout.build(sys_l, b_dummy)
        lay_u = LowerSolveLayout.build(sys_u, b_dummy)

        return cls(
            lay_l=lay_l,
            lay_u=lay_u,
            idx0=jnp.asarray(sys_l.perm, jnp.int32),
            idx1=jnp.asarray(inv_l[rev[sys_u.perm]], jnp.int32),
            idx2=jnp.asarray(inv_u[rev], jnp.int32),
            breakdowns=bad,
        )

    def apply(self, r: jax.Array) -> jax.Array:
        """z = (L L^T)^-1 r, all on device (two triangular solves)."""
        y_sys = lower_solve(
            self.lay_l, b_scale=_scatter_b(self.lay_l, r[self.idx0]),
        )
        x_sys = lower_solve(
            self.lay_u, b_scale=_scatter_b(self.lay_u, y_sys[self.idx1]),
        )
        return x_sys[self.idx2]


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("iters",))
def _pcg_ic0_run(layout, precond, b, iters):
    from hspmv.kernels.sell import spmv_ranked

    def step(i, state):
        del i
        x, r, p, rz = state
        Ap = spmv_ranked(layout, p)
        alpha = rz / jnp.maximum(_dot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond.apply(r)
        rz_new = _dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new)

    x0 = jnp.zeros_like(b)
    z0 = precond.apply(b)
    state = (x0, b, z0, _dot(b, z0))
    state = jax.lax.fori_loop(0, iters, step, state)
    return state[0], state[3]


def pcg_ic0_solve(
    layout, b: jax.Array, precond: IC0Preconditioner, iters: int = 50,
):
    """Single-card PCG with the IC(0) preconditioner: one rank-windowed
    SpMV + two level-scheduled triangular solves per iteration, the
    whole loop jitted (compile cached at module level — repeated solves
    with the same shapes reuse it). Returns (x, final r.z)."""
    return _pcg_ic0_run(layout, precond, b, iters)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedIC0Preconditioner:
    """Distributed exact IC(0): M^-1 r by two block back-substitution
    chains (dist/sts.py) per application. The chains are the inherent
    cost of an exact distributed triangular solve (each shard waits on
    its predecessors); the five index maps thread the A-space
    row-sharded vectors through the two solve systems' pack paddings
    and permutations exactly as in the single-chip IC0Preconditioner.
    """

    lay_l: object  # ShardedLowerSolve for L
    lay_u: object  # ShardedLowerSolve for reversed L^T
    bl_gather: jax.Array  # r[bl_gather] -> rows of L's rhs (m,)
    bl_scatter: jax.Array  # ... scattered to b_L_pad positions (m,)
    bu_gather: jax.Array  # x_L_pad[bu_gather] -> rows of U's rhs (m,)
    bu_scatter: jax.Array  # ... scattered to b_U_pad positions (m,)
    z_gather: jax.Array  # x_U_pad[z_gather] -> z rows (m,)
    m: int
    padded_m_a: int  # the SpMV layout's padded length (z re-padding)
    breakdowns: int = 0

    def tree_flatten(self):
        return (
            (self.lay_l, self.lay_u, self.bl_gather, self.bl_scatter,
             self.bu_gather, self.bu_scatter, self.z_gather),
            (self.m, self.padded_m_a, self.breakdowns),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def device_put(self, mesh, axis="rows"):
        # One-time placement (review r5): the two stacked solve layouts
        # shard over the mesh via their own device_put; the five (m,)
        # index maps are REPLICATED — they feed global gathers whose
        # indices cross shards, so row-sharding them buys nothing and
        # shard_layout's leading-dim rule cannot see through the nested
        # layout children anyway.
        import dataclasses as _dc

        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = NamedSharding(mesh, P())
        put = lambda a: jax.device_put(np.asarray(a), rep)
        return _dc.replace(
            self,
            lay_l=self.lay_l.device_put(mesh, axis),
            lay_u=self.lay_u.device_put(mesh, axis),
            bl_gather=put(self.bl_gather),
            bl_scatter=put(self.bl_scatter),
            bu_gather=put(self.bu_gather),
            bu_scatter=put(self.bu_scatter),
            z_gather=put(self.z_gather),
        )

    @classmethod
    def build(
        cls, mat: CSRMatrix, n_devices: int, padded_m_a: int,
    ) -> "ShardedIC0Preconditioner":
        from hspmv.dist.sts import ShardedLowerSolve

        L, bad, sys_l, inv_l, rev, sys_u, inv_u = _build_ic0_systems(mat)
        m = L.m
        zeros = np.zeros(m, np.float32)
        lay_l, pad_l = ShardedLowerSolve.build(sys_l, zeros, n_devices)
        lay_u, pad_u = ShardedLowerSolve.build(sys_u, zeros, n_devices)

        # Host arrays: device_put replicates them over the mesh.
        i32 = lambda a: np.asarray(a, np.int32)
        return cls(
            lay_l=lay_l,
            lay_u=lay_u,
            # b_L_pad[pad_l[t]] = r[perm_l[t]]
            bl_gather=i32(sys_l.perm),
            bl_scatter=i32(pad_l),
            # b_U_pad[pad_u[t]] = y[rev[perm_u[t]]]
            #                   = x_L_pad[pad_l[inv_l[rev[perm_u[t]]]]]
            bu_gather=i32(pad_l[inv_l[rev[sys_u.perm]]]),
            bu_scatter=i32(pad_u),
            # z[j] = x_U_pad[pad_u[inv_u[rev[j]]]]
            z_gather=i32(pad_u[inv_u[rev]]),
            m=m,
            padded_m_a=padded_m_a,
            breakdowns=bad,
        )

    def apply(self, r: jax.Array, mesh, axis="rows") -> jax.Array:
        """z = (L L^T)^-1 r. r: (padded_m_a,) row-sharded in A coords;
        returns z with the same length (rows beyond m are zero)."""
        from hspmv.dist.sts import sts_solve_sharded

        b_l = jnp.zeros(self.lay_l.padded_m, jnp.float32).at[
            self.bl_scatter
        ].set(r[self.bl_gather])
        x_l = sts_solve_sharded(self.lay_l, mesh, axis, b=b_l)
        b_u = jnp.zeros(self.lay_u.padded_m, jnp.float32).at[
            self.bu_scatter
        ].set(x_l[self.bu_gather])
        x_u = sts_solve_sharded(self.lay_u, mesh, axis, b=b_u)
        return jnp.zeros(self.padded_m_a, jnp.float32).at[
            jnp.arange(self.m)
        ].set(x_u[self.z_gather])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BlockJacobiIC0Preconditioner:
    """Block-Jacobi IC(0): M = blockdiag(L_d L_d^T) with one IC(0)
    factor per row shard — the classic zero-communication trade against
    the exact ShardedIC0Preconditioner (whose two D-step back-
    substitution chains serialize every application). Each shard factors
    its diagonal block A_dd (a principal submatrix of an SPD matrix,
    hence SPD) and applies (L_d L_d^T)^-1 to its local residual slice
    with two level-scheduled solves — all inside one shard_map
    with NO collectives, so application cost is independent of D. The
    preconditioner weakens as D grows (off-diagonal-block coupling is
    dropped); the solver CLI exposes both so the trade is measurable.

    Per-shard solve layouts are stacked on a leading mesh dim exactly
    like dist/sts.ShardedLowerSolve; the three gather maps (g_l, g_u,
    g_z) thread the local residual through each shard's own pack
    paddings and system permutations, with out-of-range defaults
    pointing at an appended zero slot.
    """

    # L-stage stacked strict-L slabs and solve steps.
    lvals: jax.Array
    lcols: jax.Array
    lsub_b0: jax.Array
    lsub_nb: jax.Array
    lsub_chunk: jax.Array
    lsched: object  # stacked sts.solve.LevelSchedule
    # U-stage (reversed L^T) stacked slabs and solve steps.
    uvals: jax.Array
    ucols: jax.Array
    usub_b0: jax.Array
    usub_nb: jax.Array
    usub_chunk: jax.Array
    usched: object
    g_l: jax.Array  # (D, (nc_l+1)*128) r_ext -> b_L positions
    inv_l: jax.Array  # (D, (nc_l+1)*128) 1/diag(L_d) at pad positions
    g_u: jax.Array  # (D, (nc_u+1)*128) x_L_ext -> b_U positions
    inv_u: jax.Array  # (D, (nc_u+1)*128)
    g_z: jax.Array  # (D, rows_per_shard) x_U_ext -> local z rows
    m: int
    padded_m_a: int
    rows_per_shard: int
    nc_l: int
    nc_u: int
    l_max_nb: int
    u_max_nb: int
    n_devices: int
    breakdowns: int = 0

    def tree_flatten(self):
        children = (
            self.lvals, self.lcols, self.lsub_b0, self.lsub_nb,
            self.lsub_chunk, self.lsched, self.uvals, self.ucols,
            self.usub_b0, self.usub_nb, self.usub_chunk, self.usched,
            self.g_l, self.inv_l, self.g_u, self.inv_u, self.g_z,
        )
        aux = (
            self.m, self.padded_m_a, self.rows_per_shard, self.nc_l,
            self.nc_u, self.l_max_nb, self.u_max_nb, self.n_devices,
            self.breakdowns,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def device_put(self, mesh, axis="rows"):
        from hspmv.dist.sharding import shard_layout

        return shard_layout(self, mesh, axis)

    @classmethod
    def build(
        cls, mat: CSRMatrix, n_devices: int, padded_m_a: int,
    ) -> "BlockJacobiIC0Preconditioner":
        from hspmv.formats.sell import LANES
        from hspmv.dist.sts import _stack_sell

        m = mat.m
        if padded_m_a % n_devices:
            raise ValueError("padded_m_a must divide evenly into shards")
        rows_per_shard = padded_m_a // n_devices
        sp_mat = mat.to_scipy().tocsr()

        per = []
        bad_total = 0
        for d in range(n_devices):
            r0 = min(d * rows_per_shard, m)
            r1 = min((d + 1) * rows_per_shard, m)
            m_loc = r1 - r0
            if m_loc == 0:
                # All-padding shard: a 1x1 identity keeps the stacked
                # program shape-valid; the maps below never reference it.
                block = CSRMatrix(
                    np.array([0, 1], np.int32), np.array([0], np.int32),
                    np.array([1.0], np.float32), (1, 1),
                )
            else:
                block = CSRMatrix.from_scipy(sp_mat[r0:r1, r0:r1].tocsr())
            L, bad, sys_l, inv_lp, rev, sys_u, inv_up = _build_ic0_systems(
                block
            )
            bad_total += bad
            zeros = np.zeros(L.m, np.float32)
            lay_l = LowerSolveLayout.build(sys_l, zeros, on_host=True)
            lay_u = LowerSolveLayout.build(sys_u, zeros, on_host=True)
            per.append(dict(
                m_loc=m_loc,
                slabs_l=lay_l.slabs, slabs_u=lay_u.slabs,
                sched_l=lay_l.sched, sched_u=lay_u.sched,
                pad_l=np.asarray(lay_l.pad_index, np.int64),
                pad_u=np.asarray(lay_u.pad_index, np.int64),
                inv_l=np.asarray(lay_l.inv_diag).reshape(-1),
                inv_u=np.asarray(lay_u.inv_diag).reshape(-1),
                perm_l=np.asarray(sys_l.perm, np.int64),
                perm_u=np.asarray(sys_u.perm, np.int64),
                inv_lp=inv_lp, inv_up=inv_up, rev=rev,
            ))

        nc_l = max(p["slabs_l"].num_chunks for p in per)
        nc_u = max(p["slabs_u"].num_chunks for p in per)
        (lv, lc, lb0, lnb, lch), l_max_nb = _stack_sell(
            [p["slabs_l"] for p in per], nc_l
        )
        (uv, uc, ub0, unb, uch), u_max_nb = _stack_sell(
            [p["slabs_u"] for p in per], nc_u
        )
        lsched = _restack(per, "l", lv.shape[1] // 8, nc_l)
        usched = _restack(per, "u", uv.shape[1] // 8, nc_u)

        size_l = (nc_l + 1) * LANES
        size_u = (nc_u + 1) * LANES
        D = n_devices
        g_l = np.full((D, size_l), rows_per_shard, np.int32)
        inv_l_st = np.zeros((D, size_l), np.float32)
        g_u = np.full((D, size_u), size_l, np.int32)
        inv_u_st = np.zeros((D, size_u), np.float32)
        g_z = np.full((D, rows_per_shard), size_u, np.int32)
        for d, p in enumerate(per):
            inv_l_st[d, : p["inv_l"].size] = p["inv_l"]
            inv_u_st[d, : p["inv_u"].size] = p["inv_u"]
            if p["m_loc"] == 0:
                continue
            # b_L_pad[pad_l[t]] = r_local[perm_l[t]]
            g_l[d, p["pad_l"]] = p["perm_l"]
            # b_U_pad[pad_u[t]] = x_L_pad[pad_l[inv_l[rev[perm_u[t]]]]]
            g_u[d, p["pad_u"]] = p["pad_l"][
                p["inv_lp"][p["rev"][p["perm_u"]]]
            ]
            # z_local[j] = x_U_pad[pad_u[inv_u[rev[j]]]]
            g_z[d, : p["m_loc"]] = p["pad_u"][p["inv_up"][p["rev"]]]

        jnp_ = np.asarray  # host arrays: device_put places each shard
        return cls(
            lvals=jnp_(lv), lcols=jnp_(lc), lsub_b0=jnp_(lb0),
            lsub_nb=jnp_(lnb), lsub_chunk=jnp_(lch), lsched=lsched,
            uvals=jnp_(uv), ucols=jnp_(uc), usub_b0=jnp_(ub0),
            usub_nb=jnp_(unb), usub_chunk=jnp_(uch), usched=usched,
            g_l=jnp_(g_l), inv_l=jnp_(inv_l_st),
            g_u=jnp_(g_u), inv_u=jnp_(inv_u_st), g_z=jnp_(g_z),
            m=m, padded_m_a=padded_m_a, rows_per_shard=rows_per_shard,
            nc_l=nc_l, nc_u=nc_u, l_max_nb=l_max_nb, u_max_nb=u_max_nb,
            n_devices=n_devices, breakdowns=bad_total,
        )

    def apply(self, r: jax.Array, mesh, axis="rows") -> jax.Array:
        """z = blockdiag(L_d L_d^T)^-1 r, zero communication. r:
        (padded_m_a,) row-sharded in A coords; same-shape z returned."""
        from jax.sharding import PartitionSpec as P
        from hspmv.dist.sharding import mesh_axis_size
        from hspmv.formats.sell import LANES, SellSlabs
        from hspmv.sts.solve import LevelSchedule, lower_solve_blocks

        if mesh_axis_size(mesh, axis) != self.n_devices:
            raise ValueError(
                f"preconditioner built for {self.n_devices} devices, "
                f"mesh axis {axis!r} spans "
                f"{mesh_axis_size(mesh, axis)} devices"
            )
        nc_l, nc_u = self.nc_l, self.nc_u
        Tl, Tu = self.lsched.T, self.usched.T

        def local(lv, lc, lb0, lnb, lch, ls0, lc0, lnc, lstep,
                  uv, uc, ub0, unb, uch, us0, uc0, unc, ustep,
                  gl, il, gu, iu, gz, r_loc):
            sched_l = LevelSchedule(ls0[0], lc0[0], lnc[0], lstep[0], Tl)
            sched_u = LevelSchedule(us0[0], uc0[0], unc[0], ustep[0], Tu)
            slabs_l = SellSlabs(
                vals=lv[0], cols=lc[0], sub_b0=lb0[0], sub_nb=lnb[0],
                sub_chunk=lch[0], m=nc_l * LANES, n=nc_l * LANES, nnz=0,
                num_chunks=nc_l, max_nb=self.l_max_nb, chunk_q=0,
            )
            slabs_u = SellSlabs(
                vals=uv[0], cols=uc[0], sub_b0=ub0[0], sub_nb=unb[0],
                sub_chunk=uch[0], m=nc_u * LANES, n=nc_u * LANES, nnz=0,
                num_chunks=nc_u, max_nb=self.u_max_nb, chunk_q=0,
            )
            zero1 = jnp.zeros((1,), jnp.float32)
            r_ext = jnp.concatenate([r_loc, zero1])
            b_l = (r_ext[gl[0]] * il[0]).reshape(nc_l + 1, LANES)
            x_l = lower_solve_blocks(slabs_l, sched_l, b_l).reshape(-1)
            x_l = jnp.concatenate([x_l, zero1])
            b_u = (x_l[gu[0]] * iu[0]).reshape(nc_u + 1, LANES)
            x_u = lower_solve_blocks(slabs_u, sched_u, b_u).reshape(-1)
            x_u = jnp.concatenate([x_u, zero1])
            return x_u[gz[0]][None]

        operands = (
            self.lvals, self.lcols, self.lsub_b0, self.lsub_nb,
            self.lsub_chunk, *self.lsched.tree_flatten()[0],
            self.uvals, self.ucols, self.usub_b0, self.usub_nb,
            self.usub_chunk, *self.usched.tree_flatten()[0],
            self.g_l, self.inv_l, self.g_u, self.inv_u, self.g_z, r,
        )
        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis),) * len(operands),
            out_specs=P(axis),
            check_vma=False,
        )
        return fn(*operands).reshape(-1)


@_partial(jax.jit, static_argnames=("mesh", "axis", "iters"))
def _pcg_ic0_sharded_run(layout, precond, b, mesh, axis, iters):
    from hspmv.dist.sharding import spmv_sharded

    def step(i, state):
        del i
        x, r, p, rz = state
        Ap = spmv_sharded(layout, p, mesh, axis)
        alpha = rz / jnp.maximum(_dot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond.apply(r, mesh, axis)
        rz_new = _dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new)

    x0 = jnp.zeros_like(b)
    z0 = precond.apply(b, mesh, axis)
    state = (x0, b, z0, _dot(b, z0))
    state = jax.lax.fori_loop(0, iters, step, state)
    return state[0], state[3]


def pcg_ic0_sharded(
    layout, b: jax.Array, precond, mesh, axis="rows", iters: int = 50,
):
    """Distributed PCG with the exact IC(0) preconditioner: per jitted
    iteration one sharded SpMV (halo exchange) and two block
    back-substitution chains. Compile cached at module level (mesh and
    axis ride as static jit args). Returns (x, final r.z)."""
    axis = axis if isinstance(axis, str) else tuple(axis)
    return _pcg_ic0_sharded_run(layout, precond, b, mesh, axis, iters)


def _restack(per, stage, num_subtiles, num_chunks):
    """Per-shard solve schedules of one stage, rebuilt at a common step
    size and stacked (the stacked program is shared by every shard)."""
    from hspmv.sts.solve import LevelSchedule, stack_schedules

    T = max(p[f"sched_{stage}"].T for p in per)
    scheds = []
    for p in per:
        own = p[f"sched_{stage}"]
        slabs = p[f"slabs_{stage}"]
        nc = slabs.num_chunks
        # Recover each chunk's pack from the own schedule's steps: a
        # step never spans two packs, so step order is pack order.
        c0 = np.asarray(own.step_c0)
        ncs = np.asarray(own.step_nc)
        chunk_pack = np.repeat(np.arange(c0.shape[0]), ncs)
        if chunk_pack.shape[0] < nc:
            chunk_pack = np.concatenate([
                chunk_pack,
                np.full(nc - chunk_pack.shape[0], c0.shape[0]),
            ])
        scheds.append(
            LevelSchedule.build(slabs.sub_chunk, chunk_pack, T, on_host=True)
        )
    return stack_schedules(scheds, num_subtiles, num_chunks)


__all__ = [
    "BlockJacobiIC0Preconditioner", "IC0Preconditioner",
    "ShardedIC0Preconditioner", "ic0_factor",
    "pcg_ic0_solve", "pcg_ic0_sharded",
]
