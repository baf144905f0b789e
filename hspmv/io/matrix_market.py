"""MatrixMarket (.mtx) reader/writer.

NumPy re-implementation of the role of the reference's NIST mmread.m /
mmwrite.m (reference: helpers/mmread.m:1-20, helpers/mmwrite.m) restricted
to the formats the benchmark suite actually consumes: coordinate
real/integer/pattern matrices with general/symmetric/skew-symmetric
symmetry, plus array (dense) real matrices.
"""

from __future__ import annotations

import gzip

import numpy as np

from hspmv.formats.csr import CSRMatrix


def _open(path, mode="rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_mtx(path) -> CSRMatrix:
    """Read a MatrixMarket file into a CSRMatrix (duplicates summed)."""
    with _open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: missing MatrixMarket banner")
        parts = header.split()
        if len(parts) < 5 or parts[1].lower() != "matrix":
            raise ValueError(f"{path}: unsupported banner {header!r}")
        fmt, field, symmetry = (
            parts[2].lower(),
            parts[3].lower(),
            parts[4].lower(),
        )
        if field == "complex":
            raise ValueError("complex matrices are not supported")

        line = f.readline()
        while line.startswith("%") or not line.strip():
            line = f.readline()

        if fmt == "coordinate":
            dims = line.split()
            m, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            body = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
            if body.size == 0:
                body = np.zeros((0, 3))
            if field == "pattern":
                rows = body[:, 0].astype(np.int64) - 1
                cols = body[:, 1].astype(np.int64) - 1
                vals = np.ones(rows.shape[0], dtype=np.float32)
            else:
                rows = body[:, 0].astype(np.int64) - 1
                cols = body[:, 1].astype(np.int64) - 1
                vals = body[:, 2].astype(np.float32)
            if symmetry in ("symmetric", "skew-symmetric"):
                off = rows != cols
                sign = -1.0 if symmetry == "skew-symmetric" else 1.0
                rows = np.concatenate([rows, cols[off]])
                cols = np.concatenate([cols, body[off, 0].astype(np.int64) - 1])
                vals = np.concatenate([vals, sign * vals[off]])
            elif symmetry != "general":
                raise ValueError(f"unsupported symmetry {symmetry!r}")
            return CSRMatrix.from_coo(rows, cols, vals, (m, n))

        if fmt == "array":
            dims = line.split()
            m, n = int(dims[0]), int(dims[1])
            body = np.loadtxt(f, dtype=np.float64, max_rows=m * n)
            dense = body.reshape(n, m).T  # column-major on disk
            if symmetry == "symmetric":
                dense = np.tril(dense) + np.tril(dense, -1).T
            rows, cols = np.nonzero(dense)
            return CSRMatrix.from_coo(
                rows, cols, dense[rows, cols].astype(np.float32), (m, n)
            )

        raise ValueError(f"unsupported MatrixMarket format {fmt!r}")


def write_mtx(path, mat: CSRMatrix, comment: str | None = None) -> None:
    """Write a CSRMatrix in coordinate/real/general MatrixMarket form.

    Mirrors helpers/converter_mm.m:13-21's role of persisting a permuted
    matrix back to .mtx.
    """
    with _open(path, "wt") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"%{line}\n")
        f.write(f"{mat.m} {mat.n} {mat.nnz}\n")
        row_ids = np.repeat(np.arange(mat.m), mat.row_lengths)
        np.savetxt(
            f,
            np.column_stack(
                [row_ids + 1, mat.indices.astype(np.int64) + 1, mat.data]
            ),
            fmt="%d %d %.9g",
        )
