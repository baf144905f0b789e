from hspmv.dist.sharding import (  # noqa: F401
    OverlapRanked, ShardedRanked, ShardedSell, make_row_mesh,
    spmv_overlap, spmv_sharded,
)
from hspmv.dist.solvers import cg_solve, pcg_solve  # noqa: F401


def __getattr__(name):  # lazy: sts pulls in the solve kernels
    if name in ("ShardedLowerSolve", "sts_solve_sharded"):
        from hspmv.dist import sts

        return getattr(sts, name)
    raise AttributeError(name)
