"""ctypes bindings to the C++ host-preprocessing core (libhspmv.so).

Auto-builds the shared library with `make` on first use and falls back
to the NumPy implementations when no toolchain is available. The native
routines are semantics-identical to the NumPy ones (tests assert exact
permutation equality).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_CPP_DIR = pathlib.Path(__file__).resolve().parent.parent / "cpp"
_LIB_PATH = _CPP_DIR / "libhspmv.so"
_lib = None
_load_error: str | None = None


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if not _LIB_PATH.exists() or (
            _LIB_PATH.stat().st_mtime < (_CPP_DIR / "reorder.cc").stat().st_mtime
        ):
            subprocess.run(
                ["make", "-C", str(_CPP_DIR)],
                check=True,
                capture_output=True,
                text=True,
            )
        lib = ctypes.CDLL(str(_LIB_PATH))
        I64 = ctypes.POINTER(ctypes.c_int64)
        I32 = ctypes.POINTER(ctypes.c_int32)
        F32 = ctypes.POINTER(ctypes.c_float)
        lib.hspmv_rcm.argtypes = [ctypes.c_int64, I64, I32, I64, I64]
        lib.hspmv_rcm.restype = ctypes.c_int
        lib.hspmv_hand_coarsen_boundaries.argtypes = [
            ctypes.c_int64, I64, ctypes.c_int64, I64, I64,
        ]
        lib.hspmv_hand_coarsen_boundaries.restype = ctypes.c_int
        lib.hspmv_permute_symmetric.argtypes = [
            ctypes.c_int64, I64, I32, F32, I64, I64, I32, F32,
        ]
        lib.hspmv_permute_symmetric.restype = ctypes.c_int
        lib.hspmv_maximal_matching.argtypes = [
            ctypes.c_int64, I64, I64, I64, I64, ctypes.c_int, I64,
        ]
        lib.hspmv_maximal_matching.restype = ctypes.c_int
        lib.hspmv_aligned_slots.argtypes = [
            ctypes.c_int64, I64, I32, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, I64, I64,
        ]
        lib.hspmv_aligned_slots.restype = ctypes.c_int
        lib.hspmv_sell_targets.argtypes = [
            ctypes.c_int64, ctypes.c_int64, I64, I64, ctypes.c_int64, I64, I64,
        ]
        lib.hspmv_sell_targets.restype = ctypes.c_int
        lib.hspmv_greedy_color.argtypes = [ctypes.c_int64, I64, I32, I64]
        lib.hspmv_greedy_color.restype = ctypes.c_int
        lib.hspmv_binned_slots.argtypes = [
            ctypes.c_int64, I64, I32, ctypes.c_int64, ctypes.c_int64,
            I64, I64,
        ]
        lib.hspmv_binned_slots.restype = ctypes.c_int
        lib.hspmv_level_schedule.argtypes = [ctypes.c_int64, I64, I32, I64]
        lib.hspmv_level_schedule.restype = ctypes.c_int
        lib.hspmv_ic0.argtypes = [ctypes.c_int64, I64, I32, F32, I64]
        lib.hspmv_ic0.restype = ctypes.c_int
        _lib = lib
    except Exception as e:  # toolchain missing, build failure, ...
        _load_error = str(e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    _load()
    return _load_error


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rcm(indptr, indices, edge_weights=None) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n = indptr.shape[0] - 1
    perm = np.empty(n, dtype=np.int64)
    w = _i64(edge_weights) if edge_weights is not None else None
    rc = lib.hspmv_rcm(
        n,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(w, ctypes.c_int64) if w is not None else None,
        _ptr(perm, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hspmv_rcm failed with code {rc}")
    return perm


def hand_coarsen_boundaries(indptr, nnz_budget: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    n = indptr.shape[0] - 1
    bounds = np.empty(n + 1, dtype=np.int64)
    count = np.zeros(1, dtype=np.int64)
    rc = lib.hspmv_hand_coarsen_boundaries(
        n,
        _ptr(indptr, ctypes.c_int64),
        int(nnz_budget),
        _ptr(bounds, ctypes.c_int64),
        _ptr(count, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hand_coarsen_boundaries failed with code {rc}")
    return bounds[: int(count[0]) + 1].copy()


def permute_symmetric(indptr, indices, data, perm):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float32)
    perm = _i64(perm)
    n = indptr.shape[0] - 1
    nnz = indices.shape[0]
    indptr_out = np.empty(n + 1, dtype=np.int64)
    indices_out = np.empty(nnz, dtype=np.int32)
    data_out = np.empty(nnz, dtype=np.float32)
    rc = lib.hspmv_permute_symmetric(
        n,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_float),
        _ptr(perm, ctypes.c_int64),
        _ptr(indptr_out, ctypes.c_int64),
        _ptr(indices_out, ctypes.c_int32),
        _ptr(data_out, ctypes.c_float),
    )
    if rc != 0:
        raise RuntimeError(f"permute_symmetric failed with code {rc}")
    return indptr_out, indices_out, data_out


def greedy_color(indptr, indices) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n = indptr.shape[0] - 1
    color = np.empty(n, dtype=np.int64)
    rc = lib.hspmv_greedy_color(
        n,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(color, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hspmv_greedy_color failed with code {rc}")
    return color


def level_schedule(indptr, indices) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n = indptr.shape[0] - 1
    level = np.empty(n, dtype=np.int64)
    rc = lib.hspmv_level_schedule(
        n,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(level, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hspmv_level_schedule failed with code {rc}")
    return level


def ic0(indptr, indices, data) -> tuple[np.ndarray, int]:
    """Incomplete Cholesky IC(0) in place on a lower-triangular CSR
    (columns ascending, diagonal last). Returns (factor values,
    breakdown count). See cpp/reorder.cc hspmv_ic0."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    out = np.array(data, dtype=np.float32, copy=True)
    n = indptr.shape[0] - 1
    bad = np.zeros(1, dtype=np.int64)
    rc = lib.hspmv_ic0(
        n,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(out, ctypes.c_float),
        _ptr(bad, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hspmv_ic0 failed with code {rc}")
    return out, int(bad[0])


def sell_targets(indptr, koff, lanes: int):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    koff = _i64(koff)
    m = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    dest_k = np.empty(nnz, dtype=np.int64)
    dest_l = np.empty(nnz, dtype=np.int64)
    rc = lib.hspmv_sell_targets(
        m, nnz,
        _ptr(indptr, ctypes.c_int64),
        _ptr(koff, ctypes.c_int64),
        int(lanes),
        _ptr(dest_k, ctypes.c_int64),
        _ptr(dest_l, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"sell_targets failed with code {rc}")
    return dest_k, dest_l


def aligned_slots(indptr, indices, gap: int = 128, cap_factor: float = 2.0,
                  lanes: int = 128):
    """Native cluster-aligned slot assignment (formats/sell._aligned_slots
    semantics; exact-parity tested). Returns (slots, kc)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    m = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    num_chunks = max(-(-m // lanes), 1)
    lens = np.diff(indptr)
    # Preload ordinal ranks: the fallback for over-wide chunks.
    slots = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], lens)
    kc = np.empty(num_chunks, dtype=np.int64)
    rc = lib.hspmv_aligned_slots(
        m,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        int(gap),
        ctypes.c_double(cap_factor),
        int(lanes),
        _ptr(slots, ctypes.c_int64),
        _ptr(kc, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hspmv_aligned_slots failed with code {rc}")
    return slots, kc


def binned_slots(indptr, indices, bin_blocks: int, lanes: int = 128):
    """Native column-binned slot assignment incl. the packed-delta
    repair (formats/sell._binned_slots semantics; exact-parity tested).
    Returns (slots, kc)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    m = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    num_chunks = max(-(-m // lanes), 1)
    slots = np.empty(nnz, dtype=np.int64)
    kc = np.empty(num_chunks, dtype=np.int64)
    rc = lib.hspmv_binned_slots(
        m,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        int(bin_blocks),
        int(lanes),
        _ptr(slots, ctypes.c_int64),
        _ptr(kc, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hspmv_binned_slots failed with code {rc}")
    return slots, kc


def maximal_matching(indptr, indices, edge_weights, visit, mode: str):
    """Native maximal matching round; bit-identical to the NumPy loop in
    reorder/coarsen._maximal_matching given the same visit order."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_load_error}")
    indptr = _i64(indptr)
    indices = _i64(indices)
    weights = _i64(edge_weights)
    visit = _i64(visit)
    n = indptr.shape[0] - 1
    match = np.empty(n, dtype=np.int64)
    mode_id = {"random": 0, "heavy": 1, "light": 2}[mode]
    rc = lib.hspmv_maximal_matching(
        n,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int64),
        _ptr(weights, ctypes.c_int64),
        _ptr(visit, ctypes.c_int64),
        mode_id,
        _ptr(match, ctypes.c_int64),
    )
    if rc != 0:
        raise RuntimeError(f"hspmv_maximal_matching failed with code {rc}")
    return match
