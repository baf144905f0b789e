from hspmv.bench.matrices import (  # noqa: F401
    laplacian_2d,
    laplacian_3d,
    random_banded,
    suite,
)
