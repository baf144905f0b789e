"""Sparse triangular solve (STS) subsystem.

Re-expression of the reference's STS machinery, which is
library-complete but driver-disabled there (reference:
CSRk_Graph::putInCSRkFormat STS branch spmv-csrk/csrk.cpp:693-695,
preprocessingForSTS csrk.cpp:1522-1966, incomplete_choloskey
csrk.cpp:708-789, compute_b csrk.cpp:791-808, lowerSTS csrk.cpp:79-145,
checkError csrk.cpp:809-834; disabled call site spmv-csrk/spmv.cpp:219-234).
"""

from hspmv.sts.host import (
    TriangularSystem,
    build_sts,
    compute_b,
    find_levels,
    greedy_color,
    reversed_for_upper,
    split_lu,
)
from hspmv.sts.solve import lower_solve, lower_solve_reference

__all__ = [
    "TriangularSystem",
    "build_sts",
    "compute_b",
    "find_levels",
    "greedy_color",
    "reversed_for_upper",
    "split_lu",
    "lower_solve",
    "lower_solve_reference",
    # lazy (pull in jit machinery only when used):
    "BlockJacobiIC0Preconditioner",
    "IC0Preconditioner",
    "ShardedIC0Preconditioner",
    "ic0_factor",
    "pcg_ic0_solve",
    "pcg_ic0_sharded",
]


def __getattr__(name):
    if name in (
        "BlockJacobiIC0Preconditioner", "IC0Preconditioner",
        "ShardedIC0Preconditioner", "ic0_factor",
        "pcg_ic0_solve", "pcg_ic0_sharded",
    ):
        from hspmv.sts import ic0

        return getattr(ic0, name)
    raise AttributeError(name)
