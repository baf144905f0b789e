"""hspmv — a sparse matrix-vector multiplication framework for GPUs.

Built in JAX/XLA with a C++ host preprocessing core,
providing the capabilities of the reference research suite
``computablee/heterogeneous-spmv`` (see SURVEY.md): MatrixMarket / .csr
ingestion, RCM bandwidth reduction, multilevel CSR-k construction by graph
coarsening, density-model autotuning, slab-layout SpMV kernels, a benchmark
harness with serial-oracle validation, and multi-card scaling over a
``jax.sharding.Mesh``.

Layer map:

    io/       MatrixMarket + .csr/.csr2/.csr3 text formats (reference-compatible)
    formats/  host-side CSR / CSR-k matrices and the device layouts
    reorder/  RCM, graph coarsening, permutation composition (C++ core + NumPy)
    kernels/  slab/DIA SpMV in plain XLA + cuSPARSE and XLA baselines
    tune/     density-model parameters + the layout planner
    dist/     mesh row-sharding, halo exchange, distributed solvers
    bench/    timing/validation harness, synthetic matrix generators, CSV logs
    tools/    CLI entry points (convert, reformat, stats, spmv, sweep)
"""

__version__ = "0.1.0"

from hspmv.formats.csr import CSRMatrix  # noqa: F401
