"""LDL compatibility layer (LDL/Include/ldl.h:30-47 parity).

Thin names over the simplicial engine: ldl_symbolic / ldl_numeric /
ldl_lsolve / ldl_dsolve / ldl_ltsolve / ldl_perm / ldl_permt /
ldl_valid_perm / ldl_valid_matrix.  Counterpart of
suitesparse_tpu/models/ldl.py, copied.
"""
from __future__ import annotations

import numpy as np

from ..cholesky import (Factor, analyze, dsolve as _dsolve,
                        factorize_simplicial, lsolve as _lsolve,
                        ltsolve as _ltsolve)
from ..core.common import default_common
from ..core.sparse import SparseCSC


def ldl_symbolic(A: SparseCSC, perm=None):
    """ldl_symbolic: etree + column counts of PAP'."""
    cm = default_common()
    cm.cholesky.supernodal = "simplicial"
    return analyze(A, cm, perm=perm)


def ldl_numeric(A: SparseCSC, sym=None) -> Factor:
    """ldl_numeric: up-looking LDL'."""
    return factorize_simplicial(A, sym=sym)


def ldl_lsolve(f: Factor, x):
    return _lsolve(f, x)


def ldl_dsolve(f: Factor, x):
    return _dsolve(f, x)


def ldl_ltsolve(f: Factor, x):
    return _ltsolve(f, x)


def ldl_perm(p, b):
    """x = b(p)"""
    return np.asarray(b)[np.asarray(p)]


def ldl_permt(p, b):
    """x(p) = b"""
    x = np.empty_like(np.asarray(b))
    x[np.asarray(p)] = b
    return x


def ldl_valid_perm(n, p) -> bool:
    p = np.asarray(p)
    return len(p) == n and np.array_equal(np.sort(p), np.arange(n))


def ldl_valid_matrix(A: SparseCSC) -> bool:
    return A.check() and A.nrow == A.ncol
