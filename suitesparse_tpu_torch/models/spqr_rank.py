"""spqr_rank-style rank/null-space utilities (MATLAB_Tools/spqr_rank).

Counterpart of suitesparse_tpu/models/spqr_rank.py.  The MATLAB package
builds basic solutions, null-space bases, and pseudoinverse solves on top
of SPQR's rank-revealing QR (spqr_basic.m, spqr_null.m, spqr_pinv.m,
spqr_cod.m).  Same composition here on the port's multifrontal QR: the
fronts are factorized on ``device`` (the card when None; raises without
one), and the orthogonal factor is applied on the host through qr_qmult's
front replay, so the null basis is exactly orthonormal by construction.
The MATLAB package sharpens rank decisions with subspace iteration
(spqr_ssi); we report the R-diagonal rank with the SPQR tolerance and
document the basic variant (exact for structural rank deficiency,
approximate near the tolerance).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import SparseCSC
from ..qr.spqr import (_q_out_layout, _r_matrix, qr_factorize, qr_qmult,
                       qr_rsolve, qr_rtsolve, qr_solve, qr_symbolic,
                       r_diagonal)
from ..utils.device import resolve_device


def spqr_basic(A: SparseCSC, b: np.ndarray,
               common: Optional[Common] = None,
               tol: Optional[float] = None, device=None) -> np.ndarray:
    """Basic (sparse) least-squares solution: dead columns zeroed
    (spqr_basic.m semantics; == SuiteSparseQR backslash for m >= n)."""
    return qr_solve(A, b, common=common, tol=tol, device=device)


def _null_factor(A: SparseCSC, common=None, tol=None, device=None):
    """QR of A^H with retained Q, plus the slots spanning null(A)."""
    cm = common or default_common()
    device = resolve_device(device)
    Af = A.to_full_storage() if A.stype != 0 else A
    At = Af.transpose(values=True, conjugate=True)
    S = qr_symbolic(At, cm)
    num = qr_factorize(At, S, common=cm, tol=tol, keep_q=True, device=device)
    out_maps, n_out, passthrough = _q_out_layout(S)
    # LIVE slots = output rows actually produced by the front replay (the
    # isometry's range); Q restricted to them is an orthogonal basis of the
    # input space.  null(A) = live slots minus the independent pivotal
    # slots (|diag(R)| > tol).
    live = np.zeros(n_out, dtype=bool)
    for row in out_maps:
        for od in row:
            v = od[od >= 0]
            live[v] = True
    live[n_out - len(passthrough):] = True
    ncols = S.n                      # pivotal slot count (columns of A^H)
    diag = np.abs(r_diagonal(S, num.Rbuf))
    independent = np.zeros(n_out, dtype=bool)
    independent[:ncols] = diag > num.tol
    null_slots = np.nonzero(live & ~independent)[0]
    return num, S, null_slots, n_out


def _dead_null_vectors(num, dead: np.ndarray, left: bool) -> np.ndarray:
    """Orthonormal basis of the (left) null space of R from its dead
    pivots: one vector per dead pivot d, z_d = 1, the other dead entries
    0, and the live entries from the R solve that clears every live row
    (right: R z = 0 by back substitution, qr_rsolve; left: R^H y = 0 by
    forward substitution, qr_rtsolve).  Exact when the dead pivots count
    the rank deficiency (the dead rows are then combinations of the live
    ones), whatever R's dead rows hold to the right of the diagonal."""
    R = _r_matrix(num)
    k = np.arange(len(dead))
    if left:
        Z = -qr_rtsolve(num, R[dead, :].conj().T.toarray())
    else:
        Z = -qr_rsolve(num, R[:, dead].toarray())
    Z[dead, k] = 1.0
    return np.linalg.qr(Z)[0]


def spqr_null(A: SparseCSC, common: Optional[Common] = None,
              tol: Optional[float] = None, device=None) -> np.ndarray:
    """Orthonormal basis N of null(A) (A @ N == 0, N^H N = I), dense
    (n, n-rank) -- spqr_null.m.

    Repaired against the reference, which takes Q e_d for every dead
    pivotal slot d of the QR of A^H: that is a null vector only when R's
    row d is zero right of the diagonal.  A tall A^H (wide A) keeps the
    reference's residual slots and takes R's left null vectors for the
    dead pivots (_dead_null_vectors); a tall A is factorized itself, whose
    dead pivots count its rank deficiency (the reference's QR of the wide
    A^H finds more dead pivots than null vectors), and N = P z for R's
    null vectors z."""
    cm = common or default_common()
    device = resolve_device(device)
    m, n = A.shape
    if m >= n:
        Af = A.to_full_storage() if A.stype != 0 else A
        S = qr_symbolic(Af, cm)
        num = qr_factorize(Af, S, common=cm, tol=tol, device=device)
        dead = np.nonzero(np.abs(r_diagonal(S, num.Rbuf)) <= num.tol)[0]
        if len(dead) == 0:
            return np.zeros((n, 0))
        Z = _dead_null_vectors(num, dead, left=False)
        N = np.empty_like(Z)
        N[S.sym.perm] = Z
        return N
    num, S, slots, n_out = _null_factor(A, cm, tol, device)
    if len(slots) == 0:
        return np.zeros((n, 0))
    dead = slots[slots < S.n]
    res = slots[slots >= S.n]
    E = np.zeros((n_out, len(slots)),
                 dtype=np.result_type(num.dtype, np.float64))
    E[res, np.arange(len(res))] = 1.0
    if len(dead):
        E[:S.n, len(res):] = _dead_null_vectors(num, dead, left=True)
    return qr_qmult(num, E, "QX")


def spqr_pinv(A: SparseCSC, b: np.ndarray,
              common: Optional[Common] = None,
              tol: Optional[float] = None, device=None) -> np.ndarray:
    """Pseudoinverse solve x = pinv(A) b (spqr_pinv.m): the basic
    least-squares solution with its null-space component projected out --
    N is orthonormal so the projector is I - N N^H."""
    x = qr_solve(A, b, common=common, tol=tol, device=device)
    N = spqr_null(A, common=common, tol=tol, device=device)
    if N.shape[1] == 0:
        return x
    return x - N @ (np.conj(N).T @ x)


def spqr_rank(A: SparseCSC, common: Optional[Common] = None,
              tol: Optional[float] = None, device=None) -> int:
    """Numerical rank estimate from the rank-revealing QR
    (|diag(R)| > tol, tol = 20(m+n)·eps·max‖col‖ by default)."""
    cm = common or default_common()
    device = resolve_device(device)
    Af = A.to_full_storage() if A.stype != 0 else A
    work = Af if Af.shape[0] >= Af.shape[1] else \
        Af.transpose(values=True, conjugate=True)
    S = qr_symbolic(work, cm)
    num = qr_factorize(work, S, common=cm, tol=tol, device=device)
    return num.rank
