"""Factorize: the object-oriented ``x = A \\ b`` front end.

Counterpart of suitesparse_tpu/models/factorize.py (MATLAB_Tools/Factorize
equivalent): picks the right factorization automatically -- Cholesky for
SPD-looking symmetric matrices, LU for square unsymmetric, QR for
rectangular least squares -- caches it, and exposes solve.  The numeric
factorizations run on ``device`` (the card when None; raises without one).

Two deliberate differences from the reference:

- only the not-positive-definite outcome of the Cholesky branch
  (``common.status == Status.NOT_POSDEF``; the port's ``cholesky`` raises
  nothing for it) falls through to LU.  The reference catches every
  exception there, which on the card would turn a failed build or launch
  of the Cholesky kernel into a silent LU solve; here every other
  exception propagates;
- Cholesky is guessed only for a Hermitian matrix (values, not just the
  pattern, as MATLAB's Factorize asks ``ishermitian``).  The reference
  guesses it from the pattern alone, so a pattern-symmetric matrix with
  unsymmetric values and a positive diagonal is factorized from its upper
  triangle and solved wrong.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..cholesky import cholesky
from ..core.common import Common, default_common
from ..core.sparse import SparseCSC, extract_diagonal, symmetry
from ..core.status import Status
from ..lu import umf_numeric, umf_solve, umf_symbolic
from ..qr import qr_solve
from ..utils.device import resolve_device


class Factorize:
    """F = Factorize(A); x = F.solve(b)  -- auto chol/lu/qr."""

    def __init__(self, A: SparseCSC, common: Optional[Common] = None,
                 kind: Optional[str] = None, device=None):
        self.A = A
        self.common = common or default_common()
        self.device = resolve_device(device)
        m, n = A.shape
        if kind is None:
            if m != n:
                kind = "qr"
            else:
                sym, nzdiag = symmetry(A) if A.stype == 0 else (1.0, n)
                if (sym == 1.0 and nzdiag == n and self._hermitian(A)
                        and self._diag_positive(A)):
                    kind = "cholesky"
                else:
                    kind = "lu"
        self.kind = kind
        self._build()

    @staticmethod
    def _hermitian(A: SparseCSC) -> bool:
        """Symmetric storage, or full storage with A == A^H exactly."""
        if A.stype != 0:
            return True
        S = A.to_scipy().tocsr()
        return (S != S.conj().T).nnz == 0

    @staticmethod
    def _diag_positive(A: SparseCSC) -> bool:
        d = extract_diagonal(A)
        return bool(np.all(np.real(d) > 0))

    def _build(self):
        if self.kind == "cholesky":
            self._solver = cholesky(self.A, self.common, device=self.device)
            if self.common.status != Status.NOT_POSDEF:
                return
            self.kind = "lu"           # fall through like Factorize does
        if self.kind == "lu":
            S = umf_symbolic(self.A, self.common)
            self._num = umf_numeric(self.A, S, self.common,
                                    device=self.device)
            return
        if self.kind == "qr":
            # deferred: qr_solve factors per solve (carries Q'b)
            return
        raise ValueError(f"unknown kind {self.kind}")

    def solve(self, b: np.ndarray) -> np.ndarray:
        if self.kind == "cholesky":
            return self._solver.solve(b)
        if self.kind == "lu":
            return umf_solve(self._num, b, A=self.A, common=self.common)
        return qr_solve(self.A, b, self.common, device=self.device)

    def __call__(self, b):
        return self.solve(b)


def backslash(A: SparseCSC, b: np.ndarray,
              common: Optional[Common] = None, device=None) -> np.ndarray:
    """x = A \\ b (the suite-wide front door, SPQR_backslash /
    Factorize-style auto selection)."""
    return Factorize(A, common, device=device).solve(b)
