"""Smoke run of the main paths on the GPU, through the user entry points.

    python chip_smoke.py               # one card (all phases below)
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

Phases (one process; any failure exits non-zero):
  1. card: platform, device kind and count, nvidia-smi's name and power
     limit, and the rate of a 1 GiB device-to-device copy;
  2. SpMV through `python -m hspmv.tools.spmv` at bench scale:
     banded_1m with --kernel auto and each slab/baseline kernel by name,
     lap3d_101 with --kernel dia in f32 and bf16, powerlaw_1m with
     --kernel auto. Each must print `Number Wrong: 0` and RelL2 < 1e-6
     (bf16: against the bf16-rounded operator);
  3. Jacobi-PCG through `hspmv.tools.solve` on banded_1m, one card;
  4. SpMM (B=8), STS (LS and COLOR order) and IC(0)-PCG on banded_100k;
  5. bench.py's JSON line;
  6. (--devices 4 only) spmv_sharded, spmv_overlap and CG on a 1-D mesh
     of four cards against the same on one card and the serial oracle.

The last line of standard output is one JSON object naming the device as
JAX reports it. Without a GPU the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time

REL_BAR = 1e-6
# CG iterates on 4 cards and on 1 card sum in different orders; both
# converge to the same solution, so they agree to the convergence error.
CG_AGREE_BAR = 1e-5
# Suite matrices (hspmv/bench/matrices.py) each phase runs on.
BIG, STENCIL, SKEWED, SMALL = (
    "banded_1m", "lap3d_101", "powerlaw_1m", "banded_100k",
)


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_tool(main, argv, check_rel=True) -> str:
    """Run a CLI main(argv), echoing its output; fail unless it returns 0
    (and, for SpMV-style tools, reports Number Wrong 0 and RelL2 under
    the bar)."""
    print(f"$ {main.__module__} {' '.join(argv)}", flush=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise SystemExit(f"FAILED ({rc}): {main.__module__} {argv}")
    if check_rel:
        if "Number Wrong: 0" not in out:
            raise SystemExit(f"FAILED (wrong entries): {argv}")
        rels = re.findall(r"RelL2: ([0-9.eE+-]+)", out)
        if not rels or not float(rels[-1]) < REL_BAR:
            raise SystemExit(f"FAILED (RelL2 {rels} >= {REL_BAR}): {argv}")
    print(f"  ok ({time.perf_counter() - t0:.1f}s)", flush=True)
    return out


def phase_card():
    import jax

    from hspmv.bench.harness import copy_rate
    from hspmv.hw import device_spec, nvidia_smi

    d = jax.devices()[0]
    print(f"platform={d.platform} kind={d.device_kind} "
          f"count={len(jax.devices())}")
    print(nvidia_smi(), flush=True)
    spec = device_spec()
    rate = copy_rate(2**30)
    print(f"1 GiB device copy: {rate / 1e9:.1f} GB/s "
          f"({100 * rate / spec.hbm_bytes_per_s:.0f}% of the published "
          f"{spec.hbm_bytes_per_s / 1e12:.2f} TB/s)", flush=True)


def phase_spmv():
    from hspmv.tools import spmv

    from hspmv.bench.matrices import make
    from hspmv.kernels.cusparse import CSRDevice, lowers_to_cusparse

    import jax.numpy as jnp

    small = make(SMALL)
    if not lowers_to_cusparse(CSRDevice.from_csr(small),
                              jnp.zeros(small.n, jnp.float32)):
        raise SystemExit("FAILED: --kernel cusparse does not lower to cuSPARSE")
    print("cusparse baseline lowers to a cuSPARSE call", flush=True)

    big = f"synthetic:{BIG}"
    run_tool(spmv.main, [big, "--kernel", "auto", "--validate-only"])
    run_tool(spmv.main, [big, "5", "--kernel", "auto"])
    for kernel in ("sell", "ranked", "packed", "segsum", "cusparse"):
        run_tool(spmv.main, [big, "--kernel", kernel, "--validate-only"])
    for dtype in ("f32", "bf16"):
        run_tool(spmv.main, [
            f"synthetic:{STENCIL}", "--kernel", "dia", "--rcm", "never",
            "--val-dtype", dtype, "--validate-only",
        ])
    run_tool(spmv.main, [f"synthetic:{SKEWED}", "--kernel", "auto",
                         "--validate-only"])
    run_tool(spmv.main, [f"synthetic:{SKEWED}", "5", "--kernel", "auto"])


def phase_solve():
    from hspmv.tools import solve

    run_tool(solve.main, [f"synthetic:{BIG}", "--iters", "100", "--pcg",
                          "--devices", "1"], check_rel=False)


def phase_off_main():
    from hspmv.tools import solve, spmm, sts

    small = f"synthetic:{SMALL}"
    run_tool(spmm.main, [small, "--batch", "8", "--validate-only"])
    for order in ("LS", "COLOR"):
        run_tool(sts.main, [small, "5", "--order", order], check_rel=False)
    run_tool(solve.main, [small, "--iters", "50", "--precond", "ic0",
                          "--devices", "1"], check_rel=False)


def phase_bench():
    import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        bench.main()
    line = buf.getvalue().strip().splitlines()[-1]
    rec = json.loads(line)
    if rec.get("metric") != "spmv_gflops" or not rec.get("value", 0) > 0:
        raise SystemExit(f"FAILED: bench.py line {line!r}")


def phase_four_cards():
    """Sharded SpMV, overlapped SpMV and CG on 4 cards vs 1 card and the
    serial oracle."""
    import jax
    import numpy as np

    from hspmv.bench.harness import validate
    from hspmv.bench.matrices import make
    from hspmv.dist.sharding import (
        OverlapRanked, ShardedRanked, make_row_mesh, shard_vector,
        spmv_overlap, spmv_sharded,
    )
    from hspmv.dist.solvers import cg_solve

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--devices 4 needs four cards, found {len(devs)}")
    mat = make(BIG)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y_ref = mat.matvec(x)
    out = {}
    for D in (4, 1):
        mesh = make_row_mesh(devs[:D])
        lay = ShardedRanked.build(mat, D).device_put(mesh)
        xp = np.zeros(lay.padded_m, np.float32)
        xp[: mat.n] = x
        xj = shard_vector(xp, mesh)
        out[D, "spmv"] = np.asarray(spmv_sharded(lay, xj, mesh))[: mat.m]
        if D > 1:
            olay = OverlapRanked.build(mat, D).device_put(mesh)
            out[D, "overlap"] = np.asarray(spmv_overlap(olay, xj, mesh))[: mat.m]
        b = np.zeros(lay.padded_m, np.float32)
        b[: mat.m] = 1.0
        sol, _ = cg_solve(lay, shard_vector(b, mesh), mesh, iters=100)
        out[D, "cg"] = np.asarray(sol)[: mat.m]
        del lay, xj
        jax.clear_caches()
    rel = lambda a, r: float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))
    checks = {
        "spmv 4 vs oracle": validate(out[4, "spmv"], y_ref)[1],
        "spmv 4 vs 1 card": rel(out[4, "spmv"], out[1, "spmv"]),
        "overlap 4 vs oracle": validate(out[4, "overlap"], y_ref)[1],
        "overlap 4 vs 1 card": rel(out[4, "overlap"], out[1, "spmv"]),
        "cg 4 vs 1 card": rel(out[4, "cg"], out[1, "cg"]),
    }
    resid = float(np.linalg.norm(mat.matvec(out[4, "cg"]) - 1.0)
                  / np.sqrt(mat.m))
    for k, v in checks.items():
        print(f"{k}: RelL2 {v:.3e}")
    print(f"cg 4 cards: rms residual {resid:.3e}", flush=True)
    bad = [k for k, v in checks.items()
           if not v < (CG_AGREE_BAR if k.startswith("cg") else REL_BAR)]
    if bad or not resid < 1e-4:
        raise SystemExit(f"FAILED: four-card agreement {bad} resid={resid}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2

    from hspmv.cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    phases = [phase_card]
    if args.devices == 4:
        phases.append(phase_four_cards)
    else:
        phases += [phase_spmv, phase_solve, phase_off_main, phase_bench]
    for phase in phases:
        print(f"== {phase.__name__} ({time.perf_counter() - t0:.0f}s)",
              flush=True)
        phase()
    print(f"== all phases passed ({time.perf_counter() - t0:.0f}s)")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
