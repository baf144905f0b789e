from hspmv.io.matrix_market import read_mtx, write_mtx  # noqa: F401
from hspmv.io.csr_text import (  # noqa: F401
    read_csr_text,
    write_csr_text,
    read_csr2_text,
    read_csr3_text,
    write_csr2_text,
    write_csr3_text,
)
