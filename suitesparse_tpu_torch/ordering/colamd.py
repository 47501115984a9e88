"""COLAMD / SYMAMD / CCOLAMD / CSYMAMD: column orderings for unsymmetric
factorizations (LU, QR).

API parity with the reference (COLAMD/Include/colamd.h:134-184,
CCOLAMD/Include/ccolamd.h:107-257): order the columns of A so that the
Cholesky factor of (PA)'(PA) — equivalently the LU/QR factors of A with
free row pivoting — stays sparse; constrained variants take cmember.

The production path is the native row-merge formulation
(native/src/colamd.cc): approximate column minimum degree directly on A
with rows acting as elements — A'A is never formed, matching the
reference's design (COLAMD/Source/colamd.c find_ordering :2159).  Fallback
when no toolchain is available: form the *pattern* of A'A after pruning
dense rows (> dense_row·sqrt(n) entries, the same rows COLAMD treats as
dense, colamd.h Knobs) and run the AMD core on it — same objective
(minimum degree on the column graph), more memory.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.common import Common
from ..core.sparse import INDEX, SparseCSC
from ..core.status import SparseError, Status
from .amd import _amd_impl, amd, camd


def _ata_pattern(A: SparseCSC, dense_row: float = 10.0) -> SparseCSC:
    """Pattern of A'A (no values) with dense rows of A dropped first."""
    import scipy.sparse as sp

    S = sp.csc_matrix(
        (np.ones(A.nnz, dtype=np.int8), A.indices, A.indptr), shape=A.shape)
    if dense_row is not None and dense_row > 0:
        m = A.nrow
        row_counts = np.bincount(A.indices, minlength=m)
        thresh = max(16.0, dense_row * np.sqrt(max(A.ncol, 1)))
        dense_rows = np.where(row_counts > thresh)[0]
        if len(dense_rows):
            keep = np.ones(m, dtype=bool)
            keep[dense_rows] = False
            S = S[keep, :]
    C = (S.T @ S).tocsc()
    C.sort_indices()
    return SparseCSC(C.indptr.astype(INDEX), C.indices.astype(INDEX), None,
                     C.shape)


def _native_colamd(A: SparseCSC, dense_row: float,
                   dense_col: float) -> Optional[np.ndarray]:
    from ..utils import native
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "sstpu_colamd"):
        return None
    perm = np.empty(A.ncol, dtype=np.int64)
    rc = lib.sstpu_colamd(int(A.nrow), int(A.ncol),
                          np.ascontiguousarray(A.indptr, dtype=np.int64),
                          np.ascontiguousarray(A.indices, dtype=np.int64),
                          perm, float(dense_row), float(dense_col))
    if rc < 0:
        raise SparseError(Status.INVALID, "colamd: invalid matrix")
    return perm.astype(INDEX)


def colamd(A: SparseCSC, common: Optional[Common] = None,
           dense_row: float = 10.0, dense_col: float = 10.0) -> np.ndarray:
    """Column ordering of A for LU with free row pivoting (colamd,
    colamd.h:164-184).  Returns perm over columns: perm[k] = k-th column."""
    perm = _native_colamd(A, dense_row, dense_col)
    if perm is not None:
        return perm
    del dense_col  # dense columns are handled by AMD's own postponement
    C = _ata_pattern(A, dense_row)
    return amd(C, common)


def symamd(A: SparseCSC, common: Optional[Common] = None) -> np.ndarray:
    """Symmetric-matrix ordering via the column strategy (symamd):
    for symmetric A, equivalent to AMD on the pattern of A (reference
    symamd constructs M with M'M = A and colamds it)."""
    return amd(A, common)


def ccolamd(A: SparseCSC, cmember: np.ndarray, common: Optional[Common] = None,
            dense_row: float = 10.0, for_lu: bool = True) -> np.ndarray:
    """Constrained COLAMD (ccolamd.h:157): columns ordered within constraint
    sets, sets in order — used by nested dissection to order leaves."""
    del for_lu
    cmember = np.ascontiguousarray(cmember, dtype=INDEX)
    if len(cmember) != A.ncol:
        raise SparseError(Status.INVALID, "cmember length mismatch")
    C = _ata_pattern(A, dense_row)
    return camd(C, cmember, common)


def csymamd(A: SparseCSC, cmember: np.ndarray,
            common: Optional[Common] = None) -> np.ndarray:
    """Constrained symamd (ccolamd.h csymamd)."""
    return camd(A, cmember, common)
