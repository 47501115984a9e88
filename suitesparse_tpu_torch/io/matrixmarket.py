"""MatrixMarket I/O (cholmod_read.c / cholmod_write.c equivalents).

Counterpart of suitesparse_tpu/io/matrixmarket.py, copied.

Reference behavior reproduced: reads coordinate and array formats, all four
symmetry classes (general/symmetric/skew-symmetric/hermitian), pattern
matrices (values = 1), and preserves symmetric storage as stype-coded CSC
(reference: CHOLMOD/Check/cholmod_read.c — symmetric inputs are kept
half-stored).  Writing emits the tightest symmetry class like
cholmod_write_sparse does.
"""
from __future__ import annotations

import gzip
import io as _io
from typing import Union

import numpy as np

from ..core.sparse import SYM_LOWER, UNSYM, SparseCSC, Triplet
from ..core.status import SparseError, Status


def _open(path, mode="rt"):
    if hasattr(path, "read") or hasattr(path, "write"):
        return path
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def mmread(path) -> SparseCSC:
    f = _open(path)
    header = f.readline().split()
    if len(header) < 5 or header[0] not in ("%%MatrixMarket", "%MatrixMarket"):
        raise SparseError(Status.INVALID, "not a MatrixMarket file")
    _, obj, fmt, field, symm = [s.lower() for s in header[:5]]
    if obj != "matrix":
        raise SparseError(Status.INVALID, f"unsupported object {obj}")
    if fmt not in ("coordinate", "array"):
        raise SparseError(Status.INVALID, f"unknown format {fmt}")
    if field not in ("real", "integer", "complex", "pattern"):
        raise SparseError(Status.INVALID, f"unknown field {field}")
    if symm not in ("general", "symmetric", "hermitian", "skew-symmetric"):
        raise SparseError(Status.INVALID, f"unknown symmetry {symm}")
    line = f.readline()
    while line.startswith("%") or (line and not line.strip()):
        line = f.readline()
    if not line:
        raise SparseError(Status.INVALID, "unexpected EOF before size line")
    dims = line.split()

    complex_ = field == "complex"
    pattern = field == "pattern"
    dtype = np.complex128 if complex_ else np.float64

    if fmt == "coordinate":
        nrow, ncol, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        rest = f.read()
        toks = rest.split()
        if pattern:
            arr = np.array(toks, dtype=np.int64).reshape(nnz, 2) if nnz else np.zeros((0, 2), np.int64)
            row, col, val = arr[:, 0] - 1, arr[:, 1] - 1, None
        elif complex_:
            arr = np.array(toks, dtype=np.float64).reshape(nnz, 4) if nnz else np.zeros((0, 4))
            row = arr[:, 0].astype(np.int64) - 1
            col = arr[:, 1].astype(np.int64) - 1
            val = arr[:, 2] + 1j * arr[:, 3]
        else:
            arr = np.array(toks, dtype=np.float64).reshape(nnz, 3) if nnz else np.zeros((0, 3))
            row = arr[:, 0].astype(np.int64) - 1
            col = arr[:, 1].astype(np.int64) - 1
            val = arr[:, 2]
        if symm == "general":
            stype = UNSYM
        elif symm == "symmetric":
            stype = SYM_LOWER     # MM stores the lower triangle
        elif symm == "hermitian":
            stype = SYM_LOWER
        elif symm == "skew-symmetric":
            # expand explicitly: skew has no stype analog in cholmod storage
            off = row != col
            row2 = np.concatenate([row, col[off]])
            col2 = np.concatenate([col, row[off]])
            if val is not None:
                val = np.concatenate([val, -val[off]])
            return Triplet(row2, col2, val, (nrow, ncol)).to_csc()
        else:
            raise SparseError(Status.INVALID, f"unknown symmetry {symm}")
        return Triplet(row, col, val, (nrow, ncol), stype=stype).to_csc()

    if fmt == "array":
        nrow, ncol = int(dims[0]), int(dims[1])
        vals = np.array(f.read().split(), dtype=np.float64)
        if complex_:
            vals = vals[0::2] + 1j * vals[1::2]
        if symm == "general":
            M = vals.reshape(ncol, nrow).T.astype(dtype)
        else:
            M = np.zeros((nrow, ncol), dtype=dtype)
            k = 0
            for j in range(ncol):
                m = nrow - j
                M[j:, j] = vals[k:k + m]
                k += m
            if symm == "symmetric":
                M = M + np.tril(M, -1).T
            elif symm == "hermitian":
                M = M + np.conj(np.tril(M, -1)).T
            elif symm == "skew-symmetric":
                M = M - np.tril(M, -1).T
        import scipy.sparse as sp
        return SparseCSC.from_scipy(sp.csc_matrix(M))
    raise SparseError(Status.INVALID, f"unknown format {fmt}")


def mmread_dense(path) -> np.ndarray:
    """cholmod_read_dense: array-format file to a dense ndarray."""
    A = mmread(path)
    return np.asarray(A.to_scipy().todense())


def mmwrite(path, A: Union[SparseCSC, np.ndarray], comment: str = "") -> None:
    close = not (hasattr(path, "write"))
    f = _open(path, "wt")
    try:
        if isinstance(A, np.ndarray):
            field = "complex" if np.iscomplexobj(A) else "real"
            f.write(f"%%MatrixMarket matrix array {field} general\n")
            if comment:
                f.write(f"%{comment}\n")
            f.write(f"{A.shape[0]} {A.shape[1]}\n")
            for j in range(A.shape[1]):
                for i in range(A.shape[0]):
                    v = A[i, j]
                    if field == "complex":
                        f.write(f"{v.real:.17g} {v.imag:.17g}\n")
                    else:
                        f.write(f"{v:.17g}\n")
            return
        t = A.to_triplet()
        pattern = t.data is None
        complex_ = (not pattern) and np.iscomplexobj(t.data)
        field = "pattern" if pattern else ("complex" if complex_ else "real")
        if A.stype != UNSYM:
            symm = "symmetric" if not complex_ else "hermitian"
            # MM symmetric => store lower triangle
            if A.stype > 0:
                t.row, t.col = t.col.copy(), t.row.copy()
        else:
            symm = "general"
        f.write(f"%%MatrixMarket matrix coordinate {field} {symm}\n")
        if comment:
            f.write(f"%{comment}\n")
        f.write(f"{A.nrow} {A.ncol} {t.nnz}\n")
        for k in range(t.nnz):
            i, j = t.row[k] + 1, t.col[k] + 1
            if pattern:
                f.write(f"{i} {j}\n")
            elif complex_:
                f.write(f"{i} {j} {t.data[k].real:.17g} {t.data[k].imag:.17g}\n")
            else:
                f.write(f"{i} {j} {t.data[k]:.17g}\n")
    finally:
        if close:
            f.close()
