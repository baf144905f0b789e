from hspmv.kernels.segsum import spmv_segsum, SegsumLayout  # noqa: F401
from hspmv.kernels.sell import spmv_ranked, spmv_sell  # noqa: F401


def __getattr__(name):  # lazy: keep base import light
    if name == "spmv_packed":
        from hspmv.kernels.packed import spmv_packed

        return spmv_packed
    if name == "spmv_dia":
        from hspmv.kernels.dia import spmv_dia

        return spmv_dia
    if name == "spmv_cusparse":
        from hspmv.kernels.cusparse import spmv_cusparse

        return spmv_cusparse
    raise AttributeError(name)
