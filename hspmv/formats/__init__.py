from hspmv.formats.csr import CSRMatrix  # noqa: F401
from hspmv.formats.csrk import CSRkMatrix  # noqa: F401
