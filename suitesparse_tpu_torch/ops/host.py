"""Host-side sparse matrix ops (cholmod MatrixOps equivalents on NumPy).

Counterpart of suitesparse_tpu/ops/host.py, copied.  Device counterparts
live in :mod:`suitesparse_tpu_torch.ops.spmv` and ``ops.spgemm``; these
host versions are the oracle implementations and the convenience path for
small/analysis-time work.
Reference: CHOLMOD/MatrixOps — cholmod_sdmult (t_cholmod_sdmult.c),
cholmod_ssmult, cholmod_scale, cholmod_norm.
"""
from __future__ import annotations

from typing import Union

import numpy as np

from ..core.sparse import SparseCSC, UNSYM
from ..core.status import SparseError, Status


def host_matmul(A: SparseCSC, other: Union[SparseCSC, np.ndarray]):
    if isinstance(other, SparseCSC):
        return ssmult(A, other)
    return sdmult(A, np.asarray(other))


def sdmult(A: SparseCSC, X: np.ndarray, transpose: bool = False,
           alpha: float = 1.0, beta: float = 0.0,
           Y: np.ndarray | None = None) -> np.ndarray:
    """Y = alpha*(A or A')*X + beta*Y (cholmod_sdmult)."""
    S = A.to_scipy()
    if transpose:
        S = S.T
    out = alpha * (S @ X)
    if Y is not None and beta != 0.0:
        out = out + beta * Y
    return np.asarray(out)


def ssmult(A: SparseCSC, B: SparseCSC) -> SparseCSC:
    """C = A*B (cholmod_ssmult)."""
    if A.ncol != B.nrow:
        raise SparseError(Status.INVALID, "ssmult: inner dimension mismatch")
    C = (A.to_scipy() @ B.to_scipy()).tocsc()
    C.sort_indices()
    return SparseCSC(C.indptr, C.indices, C.data, C.shape, stype=UNSYM)


def scale(A: SparseCSC, s: np.ndarray, mode: str = "row") -> SparseCSC:
    """cholmod_scale: row/col/sym/scalar scaling of A in place semantics."""
    out = A.copy()
    col = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    if mode == "row":
        out.data = out.data * s[out.indices]
    elif mode == "col":
        out.data = out.data * s[col]
    elif mode == "sym":
        out.data = out.data * s[out.indices] * s[col]
    elif mode == "scalar":
        out.data = out.data * s
    else:
        raise SparseError(Status.INVALID, f"bad scale mode {mode}")
    return out
