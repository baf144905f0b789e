"""SpMV over the DIA (diagonal-offset) layout, in plain XLA.

For stencil-class matrices (see formats/dia.py) the gather disappears:
y = sum_k vals[k] * x_pad[glo + off_k : glo + off_k + m], D statically
shifted slices of one zero-padded x that XLA fuses into a single
elementwise loop. The device bytes are the diagonal values plus one read
of x and one write of y.

Role-equivalent of the reference's density-dispatched kernel family
(spmv-csr/spmv-avx512.c lt4/gt4, reformat-auto's per-structure format
choice) for the grid-stencil end of its benchmark set.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.dia import DiaSlabs


@jax.jit
def spmv_dia(layout: DiaSlabs, x: jax.Array) -> jax.Array:
    """y = A @ x with A in DIA layout. x: (n,) -> y: (m,) float32."""
    with jax.named_scope("spmv_dia"):
        m = layout.m
        glo = max(0, -min(layout.offsets))
        ghi = max(0, max(layout.offsets))
        xp = jnp.pad(x.astype(jnp.float32), (glo, ghi))
        y = jnp.zeros((m,), jnp.float32)
        for k, off in enumerate(layout.offsets):
            y = y + layout.vals[k].astype(jnp.float32) * jax.lax.slice(
                xp, (glo + off,), (glo + off + m,)
            )
        return y


def spmv_dia_reference(layout: DiaSlabs, x) -> np.ndarray:
    """NumPy oracle over the layout itself (tests)."""
    vals = np.asarray(layout.vals, dtype=np.float32)
    m = layout.m
    xp = np.zeros(3 * m, np.float32)  # generous guard
    xp[m : m + layout.n] = np.asarray(x, np.float32)
    y = np.zeros(m, np.float32)
    rows = np.arange(m)
    for k, off in enumerate(layout.offsets):
        y += vals[k] * xp[m + rows + off]
    return y
