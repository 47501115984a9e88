"""ssmult / sfmult: sparse matrix multiply compat layer.

Counterpart of suitesparse_tpu/models/ssmult.py.  MATLAB_Tools/{SSMULT,
SFMULT} parity: `ssmult(A, B)` multiplies two sparse matrices, `sfmult(A,
X)` multiplies sparse times dense (all transpose variants).  The engines
are the port's device paths: ssmult delegates to the Gustavson SpGEMM
program (ops/spgemm.py) and sfmult to the CSR segment SpMV program
(ops/spmv.py), on ``device`` (None: the card).
"""
from __future__ import annotations

import numpy as np

from ..core.sparse import SparseCSC

__all__ = ["ssmult", "sfmult"]


def ssmult(A: SparseCSC, B: SparseCSC, at: bool = False,
           bt: bool = False, device=None) -> SparseCSC:
    """C = op(A) * op(B) over sparse operands (ssmult.m surface)."""
    from ..ops.spgemm import spgemm
    Ac = A.transpose(values=True) if at else A
    Bc = B.transpose(values=True) if bt else B
    return spgemm(Ac, Bc, device=device)


def sfmult(A: SparseCSC, X: np.ndarray, at: bool = False,
           device=None) -> np.ndarray:
    """Y = op(A) * X with dense X (sfmult.m surface, device SpMV per
    column)."""
    from ..ops.spmv import spmv_program
    Ac = A.transpose(values=True) if at else A
    X = np.asarray(X)
    one_d = X.ndim == 1
    Xk = X.reshape(A.shape[1] if not at else A.shape[0], -1)
    run = spmv_program(Ac, device)
    cols = []
    for j in range(Xk.shape[1]):
        cols.append(run(Ac.data, Xk[:, j]).cpu().numpy())
    Y = np.stack(cols, axis=1)
    return Y[:, 0] if one_d else Y
