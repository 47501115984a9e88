"""CHOLMOD/Modify equivalents: rank-k update/downdate, row add/delete.

Counterpart of suitesparse_tpu/cholesky/modify.py, copied (host NumPy in
both packages).

Reference: cholmod_updown (L D L' ± C C', CHOLMOD/Modify/cholmod_updown.c),
cholmod_rowadd / cholmod_rowdel (Modify/cholmod_rowadd.c, cholmod_rowdel.c),
and the *_solve variants that keep a solution of Lx=b current.

Method: Davis & Hager rank-1 LDL' modification (alpha/gamma recurrences),
applied per update column; the factor's pattern grows dynamically along the
update path, so columns are rebuilt through a list-of-arrays working form
and re-packed (the reference mutates its malloc'd columns in place).

updown_solve deviation (documented): the reference updates the solution
vector in O(|path|) inside the same sweep; we update the factor then
redo the forward solve in O(nnz(L)) — identical results, simpler code.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, invert_permutation
from ..core.status import SparseError, Status
from .simplicial import Factor, lsolve, solve


class _WorkFactor:
    """Column-list working form of a simplicial LDL' factor."""

    def __init__(self, f: Factor):
        if f.is_ll or f.D is None:
            raise SparseError(Status.INVALID,
                              "updown requires an LDL' factor (is_ll=False)")
        self.n = f.n
        self.D = f.D.astype(np.float64).copy()
        self.rows: list[np.ndarray] = []
        self.vals: list[np.ndarray] = []
        for j in range(f.n):
            lo, hi = int(f.Lp[j]), int(f.Lp[j + 1])
            self.rows.append(f.Li[lo + 1:hi].copy())   # below-diagonal only
            self.vals.append(f.Lx[lo + 1:hi].astype(np.float64).copy())

    def pack(self, f: Factor) -> Factor:
        n = self.n
        counts = np.array([1 + len(r) for r in self.rows], dtype=INDEX)
        Lp = np.zeros(n + 1, dtype=INDEX)
        np.cumsum(counts, out=Lp[1:])
        Li = np.empty(int(Lp[-1]), dtype=INDEX)
        Lx = np.empty(int(Lp[-1]), dtype=np.float64)
        for j in range(n):
            lo = int(Lp[j])
            Li[lo] = j
            Lx[lo] = 1.0
            k = len(self.rows[j])
            order = np.argsort(self.rows[j])
            Li[lo + 1:lo + 1 + k] = self.rows[j][order]
            Lx[lo + 1:lo + 1 + k] = self.vals[j][order]
        return Factor(n=n, perm=f.perm, Lp=Lp, Li=Li, Lx=Lx, D=self.D,
                      is_ll=False, minor=f.minor, symbolic=f.symbolic)

    # -- rank-1 modify ----------------------------------------------------
    def rank1(self, w_rows: np.ndarray, w_vals: np.ndarray, sigma: float,
              start_alpha: float = 1.0) -> bool:
        """L D L' + sigma * w w' (Davis-Hager).  Returns False if the
        downdate makes the factor indefinite."""
        wmap = dict(zip(w_rows.tolist(), w_vals.tolist()))
        alpha = start_alpha
        while wmap:
            j = min(wmap)
            wj = wmap.pop(j)
            if wj == 0.0:
                continue
            dj = self.D[j]
            abar = alpha + sigma * wj * wj / dj
            if abar <= 0.0 and sigma < 0:
                return False           # downdate not positive definite
            dnew = dj * abar / alpha
            gamma = sigma * wj / (dnew * alpha)
            alpha = abar
            rows_j = self.rows[j]
            vals_j = self.vals[j]
            # w update through column j, then column update
            # (also grows the column with w's pattern below j)
            col = dict(zip(rows_j.tolist(), vals_j.tolist()))
            for i, lij in col.items():
                wi = wmap.get(i, 0.0) - wj * lij
                wmap[i] = wi
            for i, wi in wmap.items():
                col[i] = col.get(i, 0.0) + gamma * wi
            self.rows[j] = np.array(list(col.keys()), dtype=INDEX)
            self.vals[j] = np.array(list(col.values()))
            self.D[j] = dnew
        return True


def updown(f: Factor, C: SparseCSC, update: bool = True,
           common: Optional[Common] = None) -> Factor:
    """cholmod_updown: new factor of P(A ± C C')P'.

    C is given in *natural* row order (like cholmod's C with L->Perm
    applied internally here for convenience)."""
    cm = common or default_common()
    wf = _WorkFactor(f)
    pinv = invert_permutation(f.perm)
    sigma = 1.0 if update else -1.0
    ok = True
    for k in range(C.ncol):
        lo, hi = int(C.indptr[k]), int(C.indptr[k + 1])
        rows = pinv[C.indices[lo:hi]]
        vals = C.data[lo:hi].astype(np.float64)
        order = np.argsort(rows)
        ok = wf.rank1(rows[order], vals[order], sigma)
        if not ok:
            cm.status = Status.NOT_POSDEF
            raise SparseError(Status.NOT_POSDEF,
                              "downdate makes the matrix indefinite")
    cm.status = Status.OK
    return wf.pack(f)


def updown_solve(f: Factor, C: SparseCSC, b: np.ndarray, update: bool = True,
                 common: Optional[Common] = None) -> tuple[Factor, np.ndarray]:
    """cholmod_updown_solve: update the factor and return the refreshed
    solution of the full system Ax=b (see module docstring deviation)."""
    f2 = updown(f, C, update=update, common=common)
    return f2, solve(f2, b, "A")


def rowadd(f: Factor, j: int, cj: SparseCSC,
           common: Optional[Common] = None) -> Factor:
    """cholmod_rowadd: A2 = A but with row/col j (currently unit diagonal,
    as left by rowdel) replaced by the sparse column cj (natural order)."""
    cm = common or default_common()
    n = f.n
    pinv = invert_permutation(f.perm)
    jp = int(pinv[j])
    wf = _WorkFactor(f)
    if cj.ncol != 1 or cj.nrow != n:
        raise SparseError(Status.INVALID, "rowadd: cj must be n-by-1")
    # gather permuted column entries
    lo, hi = int(cj.indptr[0]), int(cj.indptr[1])
    rows = pinv[cj.indices[lo:hi]]
    vals = cj.data[lo:hi].astype(np.float64)
    cvec = dict(zip(rows.tolist(), vals.tolist()))
    djj = float(cvec.pop(jp, 0.0))
    upper = {i: v for i, v in cvec.items() if i < jp}
    lower = {i: v for i, v in cvec.items() if i > jp}
    # l12 = D1^-1 L1^-1 c12 : sparse forward solve on the leading factor.
    # Fill rows are always > the current pivot, so ascending processing via
    # a heap over the dynamically growing support is a valid topological order.
    import heapq
    x = dict(upper)
    heap = sorted(x.keys())
    done = set()
    while heap:
        i = heapq.heappop(heap)
        if i in done:
            continue
        done.add(i)
        xi = x[i]
        if xi == 0.0:
            continue
        for r, lv in zip(wf.rows[i].tolist(), wf.vals[i].tolist()):
            if r < jp:
                if r not in x:
                    heapq.heappush(heap, r)
                x[r] = x.get(r, 0.0) - lv * xi
    l12 = {i: v / wf.D[i] for i, v in x.items()}
    dj_new = djj - sum(wf.D[i] * l12[i] * l12[i] for i in l12)
    if dj_new == 0.0:
        raise SparseError(Status.NOT_POSDEF, "rowadd: zero new pivot")
    # l32 = (c32 - L31 D1 l12) / dj
    l32 = dict(lower)
    for i, li in l12.items():
        contrib = wf.D[i] * li
        for r, lv in zip(wf.rows[i].tolist(), wf.vals[i].tolist()):
            if r > jp:
                l32[r] = l32.get(r, 0.0) - lv * contrib
    for r in list(l32.keys()):
        l32[r] /= dj_new
    # write row j of L (as entries of columns i < jp) and column j
    for i, li in l12.items():
        mask = wf.rows[i] == jp
        if mask.any():
            wf.vals[i][mask] = li
        else:
            wf.rows[i] = np.append(wf.rows[i], jp)
            wf.vals[i] = np.append(wf.vals[i], li)
    wf.D[jp] = dj_new
    wf.rows[jp] = np.array(sorted(l32.keys()), dtype=INDEX)
    wf.vals[jp] = np.array([l32[r] for r in sorted(l32.keys())])
    # trailing downdate: w = l32 with weight dj_new (sigma = -dj_new)
    if l32:
        rows_w = np.array(sorted(l32.keys()), dtype=INDEX)
        vals_w = np.array([l32[r] for r in sorted(l32.keys())]) * np.sqrt(abs(dj_new))
        ok = wf.rank1(rows_w, vals_w, -np.sign(dj_new))
        if not ok:
            cm.status = Status.NOT_POSDEF
            raise SparseError(Status.NOT_POSDEF, "rowadd downdate failed")
    cm.status = Status.OK
    return wf.pack(f)


def rowdel(f: Factor, j: int, common: Optional[Common] = None) -> Factor:
    """cholmod_rowdel: delete row/col j (replace by unit diagonal e_j)."""
    cm = common or default_common()
    pinv = invert_permutation(f.perm)
    jp = int(pinv[j])
    wf = _WorkFactor(f)
    # trailing update: add back l32 d l32'
    rows_w = wf.rows[jp].copy()
    vals_w = wf.vals[jp].copy()
    dj = float(wf.D[jp])
    # clear row j from leading columns and the column itself
    for i in range(jp):
        mask = wf.rows[i] != jp
        if mask.sum() != len(wf.rows[i]):
            wf.rows[i] = wf.rows[i][mask]
            wf.vals[i] = wf.vals[i][mask]
    wf.rows[jp] = np.empty(0, dtype=INDEX)
    wf.vals[jp] = np.empty(0)
    wf.D[jp] = 1.0
    if len(rows_w):
        ok = wf.rank1(rows_w, vals_w * np.sqrt(abs(dj)), np.sign(dj))
        if not ok:
            cm.status = Status.NOT_POSDEF
            raise SparseError(Status.NOT_POSDEF, "rowdel update failed")
    cm.status = Status.OK
    return wf.pack(f)
