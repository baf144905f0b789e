"""Benchmark: the planner's SpMV against cuSPARSE on one card.

Prints ONE JSON line:
  metric: spmv_gflops — GFLOP/s (2*nnz/TimeMin) of the layout the
          planner picks (`plan_layout`, the `--kernel auto` path) on a
          1M-row banded matrix whose f32 CSR operator (~140 MB) is about
          three times the card's L2.
  vs_baseline: cuSPARSE time / planner-kernel time (the reference's
          cusparse-spmv role, kernels/cusparse.py).
  device: platform, device kind, count, and nvidia-smi's name and power
          limit.

Timing is the reference's protocol (hspmv/bench/harness.py): warm-up
calls, then timed calls each ended by block_until_ready. The script
needs a GPU and exits non-zero without one; any failing candidate fails
the run.

HSPMV_BENCH_MATRIX names another suite matrix (hspmv/bench/matrices.py).
"""

import json
import os
import sys

import numpy as np


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX found {jax.devices()[0].platform}"
        )

    from hspmv.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from hspmv.bench.harness import bench_spmv, validate
    from hspmv.bench.matrices import make
    from hspmv.formats.dia import DiaSlabs
    from hspmv.formats.packed import PackedRanked
    from hspmv.formats.sell import RankedSlabs, SellSlabs
    from hspmv.hw import card_label, nvidia_smi
    from hspmv.kernels.cusparse import CSRDevice, spmv_cusparse
    from hspmv.kernels.dia import spmv_dia
    from hspmv.kernels.packed import spmv_packed
    from hspmv.kernels.sell import spmv_ranked, spmv_sell
    from hspmv.tune.model import plan_layout

    name = os.environ.get("HSPMV_BENCH_MATRIX", "banded_1m")
    mat = make(name)
    plan = plan_layout(mat)
    if plan.needs_rcm:
        from hspmv.reorder import rcm

        mat = mat.permuted(rcm(mat.indptr, mat.indices))
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    xj = jnp.asarray(x)
    y_oracle = mat.matvec(x)

    builders = {
        "sell": lambda: (SellSlabs.from_csr(mat), spmv_sell),
        "ranked": lambda: (
            RankedSlabs.from_csr(mat, bin_blocks=plan.bin_blocks), spmv_ranked
        ),
        "packed": lambda: (
            PackedRanked.from_csr(mat, bin_blocks=plan.bin_blocks), spmv_packed
        ),
        "dia": lambda: (DiaSlabs.from_csr(mat), spmv_dia),
    }
    label = card_label()
    results = {}
    for kname, build in (
        (plan.kernel, builders[plan.kernel]),
        ("cusparse", lambda: (CSRDevice.from_csr(mat), spmv_cusparse)),
    ):
        layout, fn = build()
        wrong, rel = validate(np.asarray(fn(layout, xj)), y_oracle)
        if wrong or not rel < 1e-6:
            raise SystemExit(
                f"{kname}: validation failed (wrong={wrong}, relL2={rel:.2e})"
            )
        res = bench_spmv(fn, layout, xj, runs=50, nnz=mat.nnz)
        results[kname] = res
        print(
            f"# {kname} on {name}: {res.gflops:.1f} GFLOP/s "
            f"(TimeMin {res.time_min * 1e6:.1f} us, TimeAvg "
            f"{res.time_avg * 1e6:.1f} us) relL2={rel:.1e} | {label}",
            file=sys.stderr,
        )
    flag, base = results[plan.kernel], results["cusparse"]
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "spmv_gflops",
        "value": round(flag.gflops, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(base.time_min / flag.time_min, 3),
        "kernel": plan.kernel,
        "matrix": name,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "name_power_limit": nvidia_smi(),
        },
    }))


if __name__ == "__main__":
    main()
