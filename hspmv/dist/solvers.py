"""Distributed solvers on top of sharded SpMV.

The reference's only driver for SpMV is the benchmark loop; real
deployments run it inside iterative solvers. Conjugate gradient is the
canonical one (and the multi-card step: SpMV over the mesh plus
psum-reduced dot products). Every f32 inner product runs at full
precision.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hspmv.dist.sharding import (  # noqa: F401
    OverlapRanked, ShardedRanked, ShardedSell, spmv_overlap, spmv_sharded,
)


def _dot(a, b):
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def _spmv_any(layout, v, mesh, axis):
    """Dispatch to the overlapped kernel when the layout carries the
    interior/edge split (OverlapRanked), else the exchange-then-compute
    path."""
    if isinstance(layout, OverlapRanked):
        return spmv_overlap(layout, v, mesh, axis)
    return spmv_sharded(layout, v, mesh, axis)


def cg_step(layout, mesh: Mesh, state, axis="rows"):
    # layout: ShardedSell, ShardedRanked (the flagship), or
    # OverlapRanked (the communication/compute-overlapped flagship).
    """One CG iteration; all vectors row-sharded over `axis`."""
    x, r, p, rz = state
    Ap = _spmv_any(layout, p, mesh, axis)
    pAp = _dot(p, Ap)
    alpha = rz / jnp.maximum(pAp, 1e-30)
    x = x + alpha * p
    r = r - alpha * Ap
    rz_new = _dot(r, r)
    beta = rz_new / jnp.maximum(rz, 1e-30)
    p = r + beta * p
    return (x, r, p, rz_new)


def cg_solve(
    layout,
    b: jax.Array,
    mesh: Mesh,
    iters: int = 50,
    axis="rows",
):
    """Solve A x = b (A SPD) with `iters` fixed CG iterations.

    b: (padded_m,) row-sharded; returns (x, final residual norm^2).
    """

    # layout rides as a jit ARGUMENT (it is a registered pytree):
    # closing over it would bake device arrays into the jaxpr, which is
    # rejected outright for multi-process (non-addressable) shardings.
    @partial(jax.jit, static_argnames=("iters",))
    def run(layout, b, iters):
        x0 = jnp.zeros_like(b)
        r0 = b
        state = (x0, r0, r0, _dot(r0, r0))
        state = jax.lax.fori_loop(
            0, iters, lambda i, s: cg_step(layout, mesh, s, axis), state
        )
        return state[0], state[3]

    return run(layout, b, iters)


def pcg_solve(
    layout,
    b: jax.Array,
    mesh: Mesh,
    inv_diag: jax.Array,
    iters: int = 50,
    axis="rows",
):
    """Jacobi-preconditioned CG: M = diag(A)^-1 applied row-locally (no
    extra communication — the preconditioner is elementwise on the
    row-sharded vectors). inv_diag: (padded_m,) row-sharded, zeros on
    padding rows. Returns (x, final r.z)."""

    def step(layout, inv_diag, state):
        x, r, p, rz = state
        Ap = _spmv_any(layout, p, mesh, axis)
        pAp = _dot(p, Ap)
        alpha = rz / jnp.maximum(pAp, 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * inv_diag
        rz_new = _dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new)

    @partial(jax.jit, static_argnames=("iters",))
    def run(layout, b, inv_diag, iters):
        x0 = jnp.zeros_like(b)
        z0 = b * inv_diag
        state = (x0, b, z0, _dot(b, z0))
        state = jax.lax.fori_loop(
            0, iters, lambda i, s: step(layout, inv_diag, s), state
        )
        return state[0], state[3]

    return run(layout, b, inv_diag, iters)
