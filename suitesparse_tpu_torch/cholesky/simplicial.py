"""Simplicial (column-by-column) Cholesky: up-looking LDL' and LL'.

Counterpart of suitesparse_tpu/cholesky/simplicial.py, copied: it is host
NumPy in the JAX package too, so it stays on the host here.  Equivalent of
CHOLMOD's simplicial path (cholmod_rowfac row-subtree up-looking
factorization, CHOLMOD/Cholesky/cholmod_rowfac.c:111-205) and of LDL
(LDL/Include/ldl.h:30-47) / CSparse cs_chol.  It is the *oracle* for the
supernodal engine and the production path for very sparse factors
(flops/lnz < supernodal_switch) and for complex matrices, the same policy
split the reference uses.

Graceful failure parity: a non-positive pivot at column k sets
status=NOT_POSDEF and minor=k, keeping columns 0..k-1 valid
(cholmod_core.h:1681-1684 semantics).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC
from ..core.status import Status
from ..graph import ereach
from .symbolic import Symbolic, analyze, _force_upper


@dataclasses.dataclass
class Factor:
    """Numeric factor P A P' = L D L' (is_ll=False) or L L' (is_ll=True).

    Simplicial CSC storage of lower-triangular L (diagonal entry stored
    first in each column; unit for LDL') plus D for LDL'.
    (cholmod_factor simplicial form, cholmod_core.h:1673+.)
    """

    n: int
    perm: np.ndarray
    Lp: np.ndarray
    Li: np.ndarray
    Lx: np.ndarray
    D: Optional[np.ndarray]       # None for LL'
    is_ll: bool
    minor: int                    # == n if ok; else first failing column
    symbolic: Optional[Symbolic] = None
    lfill: Optional[np.ndarray] = None   # per-column fill cursor (rowfac state)
    nrows_done: int = 0                  # rows factorized so far (rowfac)

    @property
    def ok(self) -> bool:
        return self.minor == self.n

    def L_scipy(self):
        import scipy.sparse as sp
        return sp.csc_matrix((self.Lx, self.Li, self.Lp), shape=(self.n, self.n))

    def to_sparse(self) -> SparseCSC:
        """cholmod_factor_to_sparse."""
        return SparseCSC(self.Lp.copy(), self.Li.copy(), self.Lx.copy(),
                         (self.n, self.n))

    def logdet(self) -> float:
        """log|det(A)| from the factor."""
        if self.is_ll:
            return float(2.0 * np.sum(np.log(np.abs(self.Lx[self.Lp[:-1]]))))
        return float(np.sum(np.log(np.abs(self.D))))


def _permuted_upper(A: SparseCSC, perm: np.ndarray) -> SparseCSC:
    from ..core.sparse import sym_upper_view
    return sym_upper_view(A).symperm(perm, values=True).sort_indices()


def factorize_simplicial(A: SparseCSC, sym: Optional[Symbolic] = None,
                         common: Optional[Common] = None,
                         ll: bool = False,
                         beta: float = 0.0) -> Factor:
    """Up-looking simplicial factorization of P(A + beta*I)P'.

    Row k: gather the row subtree pattern (ereach), forward-solve through
    already-computed columns, emit L[k, :] and the pivot.
    """
    cm = common or default_common()
    cm.checkpoint("simplicial")
    sym = sym or analyze(A, cm)
    cm.tic("factorize")
    n = sym.n
    P = _permuted_upper(A, sym.perm)
    dtype = np.result_type(P.data.dtype, np.float64)
    iscomplex = np.issubdtype(dtype, np.complexfloating)

    parent = sym.parent
    cc = sym.colcount
    Lp = np.zeros(n + 1, dtype=INDEX)
    np.cumsum(cc, out=Lp[1:])
    lnz = int(Lp[-1])
    Li = np.empty(lnz, dtype=INDEX)
    Lx = np.zeros(lnz, dtype=dtype)
    lfill = np.zeros(n, dtype=INDEX)     # entries stored in column j so far
    D = np.zeros(n, dtype=dtype)

    y = np.zeros(n, dtype=dtype)
    flag = np.zeros(n, dtype=bool)       # ereach workspace
    minor = n
    status = Status.OK
    dbound = cm.cholesky.dbound

    status, minor = _rowfac_range(P, parent, Lp, Li, Lx, lfill, D, y, flag,
                                  0, n, ll, beta, dbound, iscomplex,
                                  None, minor)

    cm.status = status
    t = cm.toc("factorize")
    cm.info.update({"factor_time": t, "minor": minor})
    return Factor(n=n, perm=sym.perm, Lp=Lp, Li=Li, Lx=Lx,
                  D=None if ll else D, is_ll=ll, minor=minor, symbolic=sym,
                  lfill=lfill, nrows_done=n)


def _rowfac_range(P, parent, Lp, Li, Lx, lfill, D, y, flag, kstart, kend,
                  ll, beta, dbound, iscomplex, mask, minor):
    """Factorize rows kstart..kend-1 of the permuted matrix P into the
    in-progress factor arrays (cholmod_rowfac.c:111-205 row loop; the mask
    argument gives cholmod_rowfac_mask semantics: rows with mask True are
    treated as identity rows of A — zero off-diagonals, unit pivot)."""
    n = len(parent)
    status = Status.OK
    Pp, Pi, Px = P.indptr, P.indices, P.data
    for k in range(kstart, kend):
        if mask is not None and mask[k]:
            # masked row: column k of the factor is the unit column
            lo = int(Lp[k])
            Li[lo] = k
            Lx[lo] = 1.0
            if not ll:
                D[k] = 1.0
            lfill[k] = 1
            continue
        patt = ereach(P, k, parent, flag)
        # scatter column k of the upper triangle: rows i <= k
        dk = beta
        for p in range(Pp[k], Pp[k + 1]):
            i = int(Pi[p])
            if mask is not None and i < k and mask[i]:
                continue
            if i < k:
                y[i] = Px[p]
            elif i == k:
                dk += Px[p]
        # sparse forward solve along the pattern (ascending = topological)
        for i in patt:
            i = int(i)
            yi = y[i]
            y[i] = 0.0
            lo = int(Lp[i])
            hi = lo + int(lfill[i])
            # column i: diagonal first, then below-diagonal rows (< k)
            sub_rows = Li[lo + 1:hi]
            sub_vals = Lx[lo + 1:hi]
            if ll:
                zi = yi / Lx[lo]                      # L[i,i]
                if len(sub_rows):
                    y[sub_rows] -= sub_vals * zi
                dk -= zi * np.conj(zi) if iscomplex else zi * zi
                lki = zi
            else:
                if len(sub_rows):
                    y[sub_rows] -= sub_vals * yi
                lki = yi / D[i]
                dk -= lki * np.conj(yi) if iscomplex else lki * yi
            Li[hi] = k
            # hermitian: the forward solve yields z_i = conj(L[k,i]);
            # store the true factor entry (cholmod stores L, not z)
            Lx[hi] = np.conj(lki) if iscomplex else lki
            lfill[i] += 1
        # pivot
        dkr = dk.real if iscomplex else dk
        if ll:
            if dkr <= dbound:
                status = Status.NOT_POSDEF
                if minor == n:
                    minor = k
                dkr = 1.0
            lo = int(Lp[k])
            Li[lo] = k
            Lx[lo] = np.sqrt(dkr)
            lfill[k] = 1
        else:
            if dkr == 0.0 or abs(dkr) <= dbound:
                if dbound > 0.0:
                    dk = dbound if dkr >= 0 else -dbound
                    status = Status.DSMALL
                else:
                    status = Status.NOT_POSDEF
                    if minor == n:
                        minor = k
                    dk = 1.0
            # hermitian: D is real by construction (imag is roundoff);
            # np.real also covers the dbound-perturbed (real) dk
            D[k] = np.real(dk) if iscomplex else dk
            lo = int(Lp[k])
            Li[lo] = k
            Lx[lo] = 1.0
            lfill[k] = 1
    return status, minor


def rowfac(A: SparseCSC, f: Factor, kstart: int, kend: int,
           common: Optional[Common] = None, beta: float = 0.0,
           mask: Optional[np.ndarray] = None) -> Factor:
    """cholmod_rowfac: incrementally factorize rows kstart..kend-1 of
    PAP' into an existing partial factor (cholmod_rowfac.c:111-205).

    The factor must have been produced by factorize_simplicial /
    previous rowfac calls with nrows_done == kstart.  With mask given,
    this is cholmod_rowfac_mask: rows k (and their off-diagonal
    contributions) with mask[k] True are treated as identity rows of A —
    the LPDASA-style masked update."""
    cm = common or default_common()
    if f.nrows_done != kstart or f.lfill is None or f.symbolic is None:
        from ..core.status import SparseError
        raise SparseError(Status.INVALID,
                          f"rowfac expects nrows_done == kstart "
                          f"({f.nrows_done} != {kstart})")
    sym = f.symbolic
    n = f.n
    kend = min(kend, n)
    P = _permuted_upper(A, sym.perm)
    dtype = f.Lx.dtype
    iscomplex = np.issubdtype(dtype, np.complexfloating)
    y = np.zeros(n, dtype=dtype)
    flag = np.zeros(n, dtype=bool)
    if mask is not None:
        mask = np.asarray(mask)[sym.perm]       # mask is in original order
    status, minor = _rowfac_range(
        P, sym.parent, f.Lp, f.Li, f.Lx, f.lfill, f.D, y, flag,
        kstart, kend, f.is_ll, beta, cm.cholesky.dbound, iscomplex,
        mask, f.minor)
    f.minor = minor
    f.nrows_done = kend
    cm.status = status
    return f


def rowfac_mask(A: SparseCSC, f: Factor, kstart: int, kend: int,
                mask: np.ndarray, common: Optional[Common] = None,
                beta: float = 0.0) -> Factor:
    """cholmod_rowfac_mask (cholmod_cholesky.h): rowfac with masked rows
    of A treated as identity rows."""
    return rowfac(A, f, kstart, kend, common, beta, mask=mask)


def alloc_factor(A: SparseCSC, sym: Optional[Symbolic] = None,
                 common: Optional[Common] = None, ll: bool = False) -> Factor:
    """Allocate an empty simplicial factor for incremental rowfac
    (cholmod_allocate_factor + symbolic analysis)."""
    cm = common or default_common()
    sym = sym or analyze(A, cm)
    n = sym.n
    P = _permuted_upper(A, sym.perm)
    dtype = np.result_type(P.data.dtype, np.float64)
    cc = sym.colcount
    Lp = np.zeros(n + 1, dtype=INDEX)
    np.cumsum(cc, out=Lp[1:])
    lnz = int(Lp[-1])
    # slots a rowfac pass leaves unfilled (masked rows, sub-symbolic
    # patterns) must stay valid: point them at their column's diagonal
    # with value zero — harmless in solves and conversions.
    Li = np.repeat(np.arange(n, dtype=INDEX), cc)
    return Factor(n=n, perm=sym.perm, Lp=Lp, Li=Li,
                  Lx=np.zeros(lnz, dtype=dtype),
                  D=None if ll else np.zeros(n, dtype=dtype), is_ll=ll,
                  minor=n, symbolic=sym, lfill=np.zeros(n, dtype=INDEX),
                  nrows_done=0)


# ---------------------------------------------------------------------------
# Solve paths (cholmod_solve systems, cholmod_solve.c:12-20; LDL
# ldl_lsolve/ldl_dsolve/ldl_ltsolve; CSparse cs_lsolve/cs_ltsolve)
# ---------------------------------------------------------------------------

def lsolve(f: Factor, b: np.ndarray) -> np.ndarray:
    """x = L \\ b (CHOLMOD_L system)."""
    x = np.array(b, dtype=np.result_type(f.Lx.dtype, b.dtype), copy=True)
    Lp, Li, Lx = f.Lp, f.Li, f.Lx
    for j in range(f.n):
        lo, hi = int(Lp[j]), int(Lp[j + 1])
        if f.is_ll:
            x[j] = x[j] / Lx[lo]
        xj = x[j]
        rows = Li[lo + 1:hi]
        if len(rows):
            x[rows] -= Lx[lo + 1:hi, None] * xj if x.ndim == 2 else Lx[lo + 1:hi] * xj
    return x


def ltsolve(f: Factor, b: np.ndarray) -> np.ndarray:
    """x = L' \\ b (CHOLMOD_Lt system)."""
    x = np.array(b, dtype=np.result_type(f.Lx.dtype, b.dtype), copy=True)
    Lp, Li, Lx = f.Lp, f.Li, f.Lx
    conj = np.conj if np.iscomplexobj(Lx) else (lambda v: v)
    for j in range(f.n - 1, -1, -1):
        lo, hi = int(Lp[j]), int(Lp[j + 1])
        rows = Li[lo + 1:hi]
        if len(rows):
            contrib = (conj(Lx[lo + 1:hi])[:, None] * x[rows]).sum(axis=0) \
                if x.ndim == 2 else np.dot(conj(Lx[lo + 1:hi]), x[rows])
            x[j] -= contrib
        if f.is_ll:
            x[j] = x[j] / conj(Lx[lo])
    return x


def dsolve(f: Factor, b: np.ndarray) -> np.ndarray:
    """x = D \\ b (CHOLMOD_D system; identity for LL')."""
    if f.is_ll or f.D is None:
        return np.array(b, copy=True)
    return (b.T / f.D).T if b.ndim == 2 else b / f.D


def solve(f: Factor, b: np.ndarray, system: str = "A") -> np.ndarray:
    """cholmod_solve: systems A, LDLt, LD, DLt, L, Lt, D, P, Pt
    (cholmod_solve.c:12-20)."""
    b = np.asarray(b)
    perm = f.perm
    if system == "P":
        return b[perm] if b.ndim == 1 else b[perm, :]
    if system == "Pt":
        out = np.empty_like(b)
        if b.ndim == 1:
            out[perm] = b
        else:
            out[perm, :] = b
        return out
    if system == "A":
        pb = b[perm] if b.ndim == 1 else b[perm, :]
        x = ltsolve(f, dsolve(f, lsolve(f, pb)))
        return solve(f, x, "Pt")
    if system in ("LDLt", "LLt"):
        return ltsolve(f, dsolve(f, lsolve(f, b)))
    if system == "LD":
        return dsolve(f, lsolve(f, b))
    if system == "DLt":
        return ltsolve(f, dsolve(f, b))
    if system == "L":
        return lsolve(f, b)
    if system == "Lt":
        return ltsolve(f, b)
    if system == "D":
        return dsolve(f, b)
    raise ValueError(f"unknown system {system!r}")


def rcond(f: Factor) -> float:
    """cholmod_rcond: min|diag|/max|diag| of the factor (LL': of L; LDL': of D)."""
    d = np.abs(f.Lx[f.Lp[:-1]]) if f.is_ll else np.abs(f.D)
    if len(d) == 0:
        return 1.0
    mx = d.max()
    return float(d.min() / mx) if mx > 0 else 0.0
