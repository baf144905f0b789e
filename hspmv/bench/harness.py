"""Benchmark harness: the reference's timing protocol.

The reference times each SpMV call on its own around a device sync:
warm-up calls, then N timed calls, reporting TimeMin/TimeMax/TimeAvg
(spmv-csrk/spmv.cpp:161-191, BASELINE.md). Here every timed call ends
with ``jax.block_until_ready``, so the host clock covers dispatch and
the device work of that one call.

Two regimes:
  * warm (bench_spmv): the same operator every call — after the first
    call an operator smaller than the card's L2 is served from cache;
  * cold (bench_spmv_cold): calls cycle over K distinct copies of the
    operator whose bytes together are at least 6x the L2 of the
    running card (hw.py), so each call streams its operator from HBM.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class BenchResult:
    time_min: float  # seconds per call
    time_max: float
    time_avg: float
    nnz: int
    runs: int
    copies: int = 1  # operator copies cycled (cold regime)

    @property
    def gflops(self) -> float:
        return 2.0 * self.nnz / self.time_min / 1e9

    @property
    def gnnzs(self) -> float:
        return self.nnz / self.time_min / 1e9

    def summary(self) -> str:
        """The reference's stdout keys (spmv-csr/spmv.c:183-185)."""
        return (
            f"TimeMin: {self.time_min:.6g}\n"
            f"TimeMax: {self.time_max:.6g}\n"
            f"TimeAvg: {self.time_avg:.6g}\n"
            f"GFLOPs: {self.gflops:.4g}\n"
        )


def _timed_calls(fn, layouts, x, warmup: int, runs: int) -> list:
    for i in range(warmup):
        jax.block_until_ready(fn(layouts[i % len(layouts)], x))
    out = []
    for i in range(runs):
        lay = layouts[i % len(layouts)]
        t0 = time.perf_counter()
        jax.block_until_ready(fn(lay, x))
        out.append(time.perf_counter() - t0)
    return out


def _result(ts: list, nnz: int, copies: int = 1) -> BenchResult:
    return BenchResult(
        time_min=min(ts), time_max=max(ts), time_avg=sum(ts) / len(ts),
        nnz=nnz, runs=len(ts), copies=copies,
    )


def bench_spmv(
    spmv, layout, x: jax.Array, runs: int = 20, warmup: int = 5,
    nnz: int | None = None,
) -> BenchResult:
    """Time `runs` calls of spmv(layout, x) after `warmup` calls."""
    if nnz is None:
        nnz = getattr(layout, "nnz")
    return _result(_timed_calls(spmv, (layout,), x, warmup, runs), nnz)


def clone_layout(layout):
    """Fresh device copy of a layout pytree (distinct buffers: the
    leaves round-trip through host memory, so XLA cannot alias two
    clones)."""
    leaves, treedef = jax.tree_util.tree_flatten(layout)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(leaf)) for leaf in leaves]
    )


def device_bytes(layout) -> int:
    """Total device bytes of a layout pytree's array leaves."""
    return sum(
        leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree_util.tree_leaves(layout)
        if hasattr(leaf, "dtype")
    )


def cold_copies(layout_bytes: int, l2_bytes: int) -> int:
    """Operator copies whose bytes together are >= 6x the L2 (at least
    2), so no call finds its operator in cache."""
    return max(2, int(np.ceil(6 * l2_bytes / max(layout_bytes, 1))))


def bench_spmv_cold(
    spmv, make_layout, x: jax.Array, nnz: int, layout_bytes: int,
    l2_bytes: int | None = None, runs: int = 20, warmup: int = 5,
) -> BenchResult:
    """Time calls that cycle over K distinct operator copies (see the
    module docstring); make_layout builds one fresh device copy."""
    if l2_bytes is None:
        from hspmv.hw import device_spec

        l2_bytes = device_spec().l2_bytes
    K = cold_copies(layout_bytes, l2_bytes)
    layouts = tuple(make_layout() for _ in range(K))
    runs = max(runs, K)
    return _result(_timed_calls(spmv, layouts, x, warmup, runs), nnz, K)


def roofline_nnzs(bytes_per_nnz: float, hbm_bytes_per_s: float | None = None) -> float:
    """Max nnz/s if the kernel were purely bound by device-memory
    bandwidth; the ceiling defaults to the running card's published
    peak (hw.py)."""
    if hbm_bytes_per_s is None:
        from hspmv.hw import device_spec

        hbm_bytes_per_s = device_spec().hbm_bytes_per_s
    return hbm_bytes_per_s / bytes_per_nnz


def copy_rate(nbytes: int = 2**30, runs: int = 10) -> float:
    """Bytes/s of one large device-to-device copy (read + write counted),
    best of `runs`, each ended by block_until_ready."""
    a = jnp.ones((nbytes // 4,), jnp.float32)
    cp = jax.jit(lambda v: v * 1.0 + 0.0)
    jax.block_until_ready(cp(a))
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(cp(a))
        best = min(best, time.perf_counter() - t0)
    return 2 * nbytes / best


def validate(y_device: np.ndarray, y_oracle_permuted: np.ndarray, tol: float = 0.01):
    """Reference validation with a magnitude-aware tolerance.

    The reference counts elements with |y - y_serial| > 0.01 absolute in
    fp32 ('Number Wrong', spmv-csrk/spmv.cpp:202-211). A pure absolute
    tolerance is ill-posed for matrices whose y entries are large: fp32
    SpMV carries O(|y| * eps * sqrt(row_len)) rounding, so any |y| above
    ~1e5 trips 0.01 on reordered-summation noise alone. We therefore
    count |delta| > tol * max(1, |y_oracle|) — the magnitude-scaled
    count: identical to the reference for O(1)-magnitude entries,
    relative-0.01 beyond. The rel-L2 report (the stricter 1e-6 bar from
    BASELINE.md) is returned beside it.
    """
    y_device = np.asarray(y_device)
    scale = np.maximum(1.0, np.abs(y_oracle_permuted))
    num_wrong = int(np.sum(np.abs(y_device - y_oracle_permuted) > tol * scale))
    rel_l2 = float(
        np.linalg.norm(y_device - y_oracle_permuted)
        / max(np.linalg.norm(y_oracle_permuted), 1e-30)
    )
    return num_wrong, rel_l2
