"""Probe: the SELL SpMV as a hand-written Pallas kernel through Triton,
timed against the plain-XLA form of the same layout (hspmv/kernels/sell.py).

The kernel lost to the XLA form on the H100 and is not part of the
program (PERF.md, "Kernel decisions"). This script keeps that result
reproducible and is where a retry starts (ROADMAP B).

Mapping (the reference's cuSpMV_2, cuda-spmv-csrk/cuda/csrk.cu): one
program per 128-row chunk, one lane per row. The program walks its
chunk's (8, 128) sub-tiles in order, gathers x from device memory at the
slot columns, keeps each row's sum in registers and stores its 128
outputs once. Every row sums in a fixed order (sub-tile by sub-tile, the
8 slots of a sub-tile together); there are no atomics.

    python probes/triton_sell.py [matrix ...] [--runs 30]

Matrices are suite names (hspmv/bench/matrices.py); the default is
banded_1m lap3d_101 powerlaw_1m. Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hspmv.formats.sell import LANES, SUBLANES, SellSlabs  # noqa: E402


def _chunk_kernel(start_ref, vals_ref, cols_ref, x_ref, y_ref):
    c = pl.program_id(0)

    def body(s, acc):
        rows = pl.ds(s * SUBLANES, SUBLANES)
        prod = vals_ref[rows, :] * x_ref[cols_ref[rows, :]]
        return acc + jnp.sum(prod, axis=0)

    acc = jax.lax.fori_loop(
        start_ref[c], start_ref[c + 1], body, jnp.zeros((LANES,), jnp.float32)
    )
    y_ref[pl.ds(c * LANES, LANES)] = acc


@functools.partial(jax.jit, static_argnames=("m", "num_warps", "interpret"))
def _spmv(starts, vals, cols, x, *, m, num_warps, interpret):
    nc = starts.shape[0] - 1
    return pl.pallas_call(
        _chunk_kernel,
        out_shape=jax.ShapeDtypeStruct((nc * LANES,), jnp.float32),
        grid=(nc,),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
    )(starts, vals, cols, x)[:m]


def chunk_starts(layout: SellSlabs) -> np.ndarray:
    """(num_chunks + 1,) first sub-tile of every chunk, and the end."""
    return np.searchsorted(
        np.asarray(layout.sub_chunk), np.arange(layout.num_chunks + 1)
    ).astype(np.int32)


def spmv_sell_triton(layout: SellSlabs, starts, x, num_warps: int = 4):
    """y = A @ x for a SellSlabs layout through the Triton kernel.
    Interpret mode only when the operands live on the CPU."""
    interpret = next(iter(x.devices())).platform == "cpu"
    return _spmv(
        jnp.asarray(starts), layout.vals, layout.cols, x, m=layout.m,
        num_warps=num_warps, interpret=interpret,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("matrices", nargs="*",
                    default=["banded_1m", "lap3d_101", "powerlaw_1m"])
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("probes/triton_sell.py needs a GPU", file=sys.stderr)
        return 2

    from hspmv.bench.harness import bench_spmv, validate
    from hspmv.bench.matrices import make
    from hspmv.hw import card_label
    from hspmv.kernels.sell import spmv_sell
    from hspmv.reorder import rcm
    from hspmv.tune.model import plan_layout

    print(f"device: {card_label()}", flush=True)
    failed = False
    for name in args.matrices:
        mat = make(name)
        if plan_layout(mat).needs_rcm:
            mat = mat.permuted(rcm(mat.indptr, mat.indices))
        layout = SellSlabs.from_csr(mat)
        starts = jnp.asarray(chunk_starts(layout))
        x_h = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
        x = jnp.asarray(x_h)
        y_ref = mat.matvec(x_h)
        forms = {"xla": spmv_sell}
        for w in (4, 8):
            forms[f"triton_w{w}"] = functools.partial(
                lambda lay, v, w: spmv_sell_triton(lay, starts, v, w), w=w
            )
        for label, fn in forms.items():
            wrong, rel = validate(np.asarray(fn(layout, x)), y_ref)
            if label == "xla":
                temp = spmv_sell.lower(layout, x).compile().memory_analysis()
            else:
                temp = _spmv.lower(
                    starts, layout.vals, layout.cols, x, m=layout.m,
                    num_warps=int(label[-1]), interpret=False,
                ).compile().memory_analysis()
            res = bench_spmv(fn, layout, x, runs=args.runs)
            print(
                f"{name} {label}: TimeMin {res.time_min * 1e6:.1f} us "
                f"TimeAvg {res.time_avg * 1e6:.1f} us "
                f"temp_bytes {temp.temp_size_in_bytes} "
                f"Number Wrong {wrong} RelL2 {rel:.3g}",
                flush=True,
            )
            failed |= wrong != 0 or not rel < 1e-6
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
