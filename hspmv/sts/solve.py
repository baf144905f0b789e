"""Level-scheduled lower-triangular solve over a pack-padded SELL layout.

The reference solves packs one after another with an OpenMP barrier
between packs and row-parallel threads inside each pack
(CSRk_Graph::lowerSTS, spmv-csrk/csrk.cpp:79-145). Rows inside one pack
are mutually independent (hspmv/sts/host.py invariant), so a pack's rows
can all be finished in one data-parallel step once every earlier pack is
final. The device solve is exactly that:

  * rows are laid out pack by pack, each pack padded to 128-row chunks
    (a chunk never straddles a pack boundary),
  * strict-L is stored as SELL slabs over the padded rows, values
    pre-scaled by 1/diag (division-free solve),
  * one ``lax.fori_loop`` runs over steps; a step covers at most
    ``LevelSchedule.T`` consecutive sub-tiles of ONE pack, gathers x at
    their columns (all in earlier packs, hence final), reduces each
    chunk, and writes x[chunk] = b_scaled[chunk] - sum for its chunks.

A pack larger than T sub-tiles takes several steps; T itself trades the
masked work of short steps against the fixed cost of a step (see
choose_step).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from hspmv.formats.csr import CSRMatrix
from hspmv.formats.sell import LANES, SUBLANES, SellSlabs, _to_device
from hspmv.kernels.slab import subtile_partials
from hspmv.sts.host import TriangularSystem

# Fixed cost of one solve step, in sub-tiles of streamed slab work: a
# step is a few dependent launches (slice, gather-reduce, segment-sum,
# update), each far longer than streaming one 8 KB sub-tile. Not
# calibrated on a card; it only steers choose_step.
STEP_COST_SUBTILES = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _round_up_arr(a: np.ndarray, mult: int) -> np.ndarray:
    return -(-a // mult) * mult


def choose_step(pack_subtiles: np.ndarray, min_step: int) -> int:
    """Power-of-two sub-tiles per step minimising
    sum_p ceil(S_p / T) * (T + STEP_COST_SUBTILES), T >= min_step (the
    largest chunk, which a step may not split)."""
    sizes = np.asarray(pack_subtiles, np.int64)
    sizes = sizes[sizes > 0]
    T = 1 << max(int(min_step) - 1, 0).bit_length()
    top = max(T, 1 << max(int(sizes.max(initial=1)) - 1, 0).bit_length())
    best = None
    while T <= top:
        cost = int((-(-sizes // T) * (T + STEP_COST_SUBTILES)).sum())
        if best is None or cost < best[0]:
            best = (cost, T)
        T *= 2
    return best[1]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class LevelSchedule:
    """Solve steps over a SellSlabs layout: step i covers sub-tiles
    [step_s0[i], step_s0[i] + T) of which those with sub_step == i are
    its own, and finalizes chunks [step_c0[i], step_c0[i] + step_nc[i])."""

    step_s0: jax.Array  # (steps,) int32
    step_c0: jax.Array  # (steps,) int32
    step_nc: jax.Array  # (steps,) int32
    sub_step: jax.Array  # (S,) int32 owning step per sub-tile (-1: none)
    T: int  # sub-tiles per step (static)

    def tree_flatten(self):
        return (self.step_s0, self.step_c0, self.step_nc, self.sub_step), (self.T,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def num_steps(self) -> int:
        return int(self.step_s0.shape[-1])

    @staticmethod
    def pack_subtiles(sub_chunk: np.ndarray, chunk_pack: np.ndarray) -> np.ndarray:
        """Sub-tiles per pack (real sub-tiles only)."""
        sc = np.asarray(sub_chunk)
        real = sc[sc < chunk_pack.shape[0]]
        return np.bincount(chunk_pack[real], minlength=int(chunk_pack.max(initial=0)) + 1)

    @classmethod
    def build(
        cls, sub_chunk, chunk_pack: np.ndarray, T: int | None = None,
        on_host: bool = False,
    ) -> "LevelSchedule":
        """sub_chunk: (S,) sorted owning chunk per sub-tile (num_chunks
        for inert padding); chunk_pack: (num_chunks,) non-decreasing
        pack id per chunk. on_host keeps the arrays in NumPy."""
        sc = np.asarray(sub_chunk, np.int64)
        chunk_pack = np.asarray(chunk_pack, np.int64)
        nc = chunk_pack.shape[0]
        real = int(np.searchsorted(sc, nc))
        counts = np.bincount(sc[:real], minlength=nc)
        if T is None:
            T = choose_step(cls.pack_subtiles(sc, chunk_pack), counts.max(initial=1))
        if counts.max(initial=0) > T:
            raise ValueError(f"a chunk spans {counts.max()} sub-tiles > step {T}")
        starts = np.zeros(nc + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        s0, c0, ncs = [], [], []
        sub_step = np.full(sc.shape[0], -1, np.int64)
        c = 0
        while c < nc:
            # Greedy: extend over whole chunks of the same pack while the
            # step stays within T sub-tiles.
            e = c + 1
            while (e < nc and chunk_pack[e] == chunk_pack[c]
                   and starts[e + 1] - starts[c] <= T):
                e += 1
            sub_step[starts[c]:starts[e]] = len(s0)
            s0.append(starts[c])
            c0.append(c)
            ncs.append(e - c)
            c = e
        i32 = lambda a: np.asarray(a, np.int64).astype(np.int32)
        sched = cls(i32(s0), i32(c0), i32(ncs), i32(sub_step), int(T))
        return sched if on_host else _to_device(sched)


def stack_schedules(scheds: list, num_subtiles: int, num_chunks: int) -> LevelSchedule:
    """Stack per-shard schedules (common T) on a leading axis; shorter
    ones get no-op steps that finalize no chunk."""
    T = scheds[0].T
    steps = max(s.num_steps for s in scheds)

    def pad(a, n, fill):
        a = np.asarray(a)
        return np.concatenate([a, np.full(n - a.shape[0], fill, a.dtype)])

    # Host arrays: the owning layout's device_put places each shard.
    return LevelSchedule(
        step_s0=np.stack([pad(s.step_s0, steps, num_subtiles) for s in scheds]),
        step_c0=np.stack([pad(s.step_c0, steps, num_chunks) for s in scheds]),
        step_nc=np.stack([pad(s.step_nc, steps, 0) for s in scheds]),
        sub_step=np.stack([pad(s.sub_step, num_subtiles, -1) for s in scheds]),
        T=T,
    )


def lower_solve_blocks(
    slabs: SellSlabs, sched: LevelSchedule, b_scale: jax.Array,
) -> jax.Array:
    """Level-scheduled solve over pre-built strict-L slabs; returns x as
    (num_chunks + 1, 128) padded blocks. b_scale: (num_chunks + 1, 128)
    right-hand side already scaled by 1/diag. The distributed solve
    (dist/sts.py) calls this per shard inside shard_map."""
    T = sched.T
    nc = slabs.num_chunks
    pad_rows = lambda a, n, fill: jnp.concatenate(
        [a, jnp.full((n,) + a.shape[1:], fill, a.dtype)]
    )
    vals = pad_rows(slabs.vals, T * SUBLANES, 0)
    cols = pad_rows(slabs.cols, T * SUBLANES, 0)
    sub_chunk = pad_rows(slabs.sub_chunk, T, nc)
    sub_step = pad_rows(sched.sub_step, T, -1)
    b_pad = pad_rows(b_scale, T, 0.0)
    local = jnp.arange(T, dtype=jnp.int32)

    def step(i, x):
        with jax.named_scope("sts_level"):
            s0 = sched.step_s0[i]
            c0 = sched.step_c0[i]
            v = jax.lax.dynamic_slice_in_dim(vals, s0 * SUBLANES, T * SUBLANES)
            c = jax.lax.dynamic_slice_in_dim(cols, s0 * SUBLANES, T * SUBLANES)
            part = subtile_partials(v, c, x.reshape(-1))
            own = jax.lax.dynamic_slice_in_dim(sub_step, s0, T) == i
            seg = jnp.where(
                own, jax.lax.dynamic_slice_in_dim(sub_chunk, s0, T) - c0, T
            )
            acc = jax.ops.segment_sum(part, seg, num_segments=T + 1)[:T]
            b = jax.lax.dynamic_slice_in_dim(b_pad, c0, T)
            old = jax.lax.dynamic_slice_in_dim(x, c0, T)
            new = jnp.where((local < sched.step_nc[i])[:, None], b - acc, old)
            return jax.lax.dynamic_update_slice_in_dim(x, new, c0, 0)

    x = jnp.zeros((nc + 1 + T, LANES), jnp.float32)
    x = jax.lax.fori_loop(0, sched.num_steps, step, x)
    return x[: nc + 1]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class LowerSolveLayout:
    """Device arrays for the level-scheduled lower solve.

    Known cost characteristic: every pack pads to a 128-row chunk, so
    LS schedules with many tiny levels (long dependency chains, e.g.
    near-tridiagonal L) inflate slab storage and step count — prefer
    COLOR ordering where the structure admits it.
    """

    slabs: SellSlabs  # strict-L (scaled) over padded rows
    sched: LevelSchedule
    b_scale: jax.Array  # (num_chunks+1, 128) b * inv_diag, padded
    inv_diag: jax.Array  # (num_chunks+1, 128) for re-scaling new b vectors
    pad_index: jax.Array  # (m,) padded position of each real row
    m: int

    def tree_flatten(self):
        children = (
            self.slabs, self.sched, self.b_scale, self.inv_diag,
            self.pad_index,
        )
        return children, (self.m,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def build(
        cls, sys: TriangularSystem, b: np.ndarray, on_host: bool = False,
    ) -> "LowerSolveLayout":
        """Build from a host TriangularSystem and right-hand side b
        (both in the system's permuted row order). on_host keeps every
        array in NumPy (per-shard builds of the sharded layouts)."""
        L = sys.lower
        m = L.m
        lens = L.row_lengths
        if not np.all(lens >= 1):
            raise ValueError("lower factor has an empty row (missing diagonal)")
        # Columns are sorted ascending, so the diagonal is each row's last
        # entry (the reference relies on the same invariant,
        # csrk.cpp:86-88: val_L[num_edges_L[j+1]-1]).
        diag_pos = L.indptr[1:].astype(np.int64) - 1
        diag = L.data[diag_pos]
        if np.any(diag == 0.0):
            raise ValueError("zero diagonal entry; system is singular")
        inv_diag = (1.0 / diag).astype(np.float32)

        pad_index, pad_start = pack_padding(sys)
        m_pad = int(pad_start[-1])

        # Strict lower (drop the diagonal = last entry per row), values
        # scaled by the owning row's inv_diag, columns remapped to padded.
        keep = np.ones(L.nnz, dtype=bool)
        keep[diag_pos] = False
        rows = np.repeat(np.arange(m, dtype=np.int64), lens)[keep]
        cols = pad_index[L.indices[keep].astype(np.int64)]
        vals = (L.data[keep].astype(np.float64) * inv_diag[rows]).astype(np.float32)
        s_indptr = np.zeros(m_pad + 1, dtype=np.int64)
        np.add.at(s_indptr, pad_index[rows] + 1, 1)
        np.cumsum(s_indptr, out=s_indptr)
        # pad_index is strictly increasing, so the entries are already
        # row-major in padded space.
        strictL = CSRMatrix(
            s_indptr.astype(np.int32),
            cols.astype(np.int32),
            vals,
            (m_pad, m_pad),
        )
        slabs = SellSlabs.from_csr(strictL, on_host=True)
        sched = LevelSchedule.build(
            slabs.sub_chunk, chunk_packs(pad_start, slabs.num_chunks),
            on_host=True,
        )

        num_chunks = slabs.num_chunks
        bpad = np.zeros((num_chunks + 1) * LANES, dtype=np.float32)
        dpad = np.zeros((num_chunks + 1) * LANES, dtype=np.float32)
        bpad[pad_index] = np.asarray(b, dtype=np.float32) * inv_diag
        dpad[pad_index] = inv_diag
        layout = cls(
            slabs=slabs,
            sched=sched,
            b_scale=bpad.reshape(num_chunks + 1, LANES),
            inv_diag=dpad.reshape(num_chunks + 1, LANES),
            pad_index=pad_index.astype(np.int32),
            m=m,
        )
        return layout if on_host else _to_device(layout)


def pack_padding(sys: TriangularSystem) -> tuple[np.ndarray, np.ndarray]:
    """(pad_index, pad_start): each pack padded to whole 128-row chunks;
    pad_index maps the system's rows to padded rows, pad_start is the
    (num_packs + 1,) first padded row of every pack."""
    pack_sizes = np.diff(sys.pack_ptr)
    padded_sizes = np.maximum(_round_up_arr(pack_sizes, LANES), LANES)
    pad_start = np.zeros(sys.num_packs + 1, dtype=np.int64)
    np.cumsum(padded_sizes, out=pad_start[1:])
    row_pack = np.repeat(np.arange(sys.num_packs, dtype=np.int64), pack_sizes)
    pad_index = pad_start[row_pack] + (
        np.arange(sys.lower.m, dtype=np.int64) - sys.pack_ptr[row_pack]
    )
    return pad_index, pad_start


def chunk_packs(pad_start: np.ndarray, num_chunks: int, first_chunk: int = 0) -> np.ndarray:
    """Pack id of chunks [first_chunk, first_chunk + num_chunks); chunks
    past the last pack (shard padding) form one extra final pack."""
    c = np.arange(first_chunk, first_chunk + num_chunks, dtype=np.int64)
    return np.searchsorted(pad_start, c * LANES, side="right") - 1


@jax.jit
def lower_solve(
    layout: LowerSolveLayout, b_scale: jax.Array | None = None,
) -> jax.Array:
    """Solve L x = b. b_scale overrides the layout's baked-in scaled rhs
    ((num_chunks+1, 128), = b_padded * inv_diag). Returns x (m,) in the
    system's permuted row order."""
    if b_scale is None:
        b_scale = layout.b_scale
    x_pad = lower_solve_blocks(layout.slabs, layout.sched, b_scale)
    return x_pad.reshape(-1)[layout.pad_index]


def lower_solve_reference(sys: TriangularSystem, b: np.ndarray) -> np.ndarray:
    """Serial forward substitution oracle (reference lowerSTS k=2 semantics,
    csrk.cpp:81-90), in float64 for a tight accuracy bar."""
    L = sys.lower
    x = np.zeros(L.m, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    indptr, indices, data = L.indptr, L.indices, L.data.astype(np.float64)
    for i in range(L.m):
        s, e = indptr[i], indptr[i + 1]
        acc = 0.0
        for j in range(s, e - 1):
            acc += data[j] * x[indices[j]]
        x[i] = (b[i] - acc) / data[e - 1]
    return x
