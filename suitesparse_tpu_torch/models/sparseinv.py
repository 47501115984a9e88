"""sparseinv: the sparse inverse subset (Takahashi equations).

MATLAB_Tools/sparseinv parity (reference sparseinv.m / sparseinv.c
behavior): given square full-rank A, compute Z with Z[i,j] = inv(A)[i,j]
for every (i,j) in the symmetric fill pattern of the factorization —
||Zpattern .* (Z - inv(A))|| is small without ever forming inv(A).

Implementation (host; an independent derivation from Erisman-Tinney 1975,
NOT a translation of sparseinv.c): factor C = P R^{-1} A Q = (L+I) D (U+I)
with our own KLU Gilbert-Peierls path (BTF off so the factor is global),
then run the Takahashi recurrences backward over the columns of the
symmetrized fill pattern:

    Z[j,j] = 1/d[j] - sum_{k>j} U[j,k] Z[k,j]
    Z[i,j] = -sum_{k>j} Z[i,k] L[k,j]          (i > j, lower part)
    Z[i,j] = -sum_{k>i} U[i,k] Z[k,j]          (i < j, upper part)

The fill-path closure of the (symmetrized) L+U pattern guarantees every
Z entry the recurrences touch is itself in the pattern.  Finally
inv(A) = Q Z P R^{-1} maps the subset back to A's coordinates.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, Triplet
from ..core.status import SparseError, Status

__all__ = ["sparseinv"]


def sparseinv(A: SparseCSC, common: Optional[Common] = None):
    """Returns (Z, Zpattern): Z is an (n x n) scipy CSC holding the
    inverse subset; Zpattern its boolean pattern (both in A's original
    row/column coordinates)."""
    import scipy.sparse as sp
    from ..lu.klu import klu_analyze, klu_factor

    n = A.ncol
    if A.nrow != n:
        raise SparseError(Status.INVALID, "sparseinv needs a square matrix")
    cm = copy.deepcopy(common) if common is not None else default_common()
    cm.lu.btf = False            # global factor: Takahashi spans all of C
    cm.disarm() if hasattr(cm, "disarm") else None
    sym = klu_analyze(A, cm)
    num = klu_factor(A, sym, cm)
    if not num.ok:
        raise SparseError(Status.INVALID, "sparseinv: singular matrix")
    blk = num.blocks[0]

    # unpack the single block into unit L, diag d, unit U (CSC columns)
    Lp, Li, Lx = blk.Lp, blk.Li, blk.Lx           # unit lower, no diagonal
    Up, Ui, Ux = blk.Up, blk.Ui, blk.Ux           # upper, pivot LAST per col
    d = np.empty(n)
    for j in range(n):
        d[j] = Ux[int(Up[j + 1]) - 1]
    Ucols_i, Ucols_x = [], []
    for j in range(n):
        lo, hi = int(Up[j]), int(Up[j + 1])
        Ucols_i.append(Ui[lo:hi - 1])
        # C = L D Ubar: the unit upper factor divides each entry by its
        # ROW's pivot (U[i,k] = d_i * Ubar[i,k])
        Ucols_x.append(Ux[lo:hi - 1] / d[Ui[lo:hi - 1]])
    # CSR view of unit U (rows i -> columns k > i) for the upper recurrence
    Urow_j: list[list[int]] = [[] for _ in range(n)]
    Urow_x: list[list[float]] = [[] for _ in range(n)]
    for j in range(n):
        for t in range(len(Ucols_i[j])):
            i = int(Ucols_i[j][t])
            Urow_j[i].append(j)
            Urow_x[i].append(float(Ucols_x[j][t]))

    # Zpattern = symbolic CHOLESKY pattern of C+C' (the reference's choice,
    # sparseinv.m): unlike pattern(L+U+transpose) it is CLOSED under the
    # Takahashi recurrences (fill-path theorem on the symmetrized graph)
    LU = sp.csc_matrix((np.ones(len(Li)), Li, Lp), shape=(n, n)) \
        + sp.csc_matrix((np.ones(len(Ui)), Ui, Up), shape=(n, n))
    Ssym = ((LU + LU.T) != 0).tocsc()
    Ssym.setdiag(1)
    Ssym = (Ssym != 0).tocsc()
    Ssym.sort_indices()
    # Liu's row-subtree symbolic factorization: row i's L pattern is the
    # union of etree paths from each entry k < i of row i up to i, with
    # the etree grown on the fly
    parent = np.full(n, -1, dtype=np.int64)
    mark = np.full(n, -1, dtype=np.int64)
    Lpat: list[list[int]] = [[] for _ in range(n)]   # col j -> rows i > j
    indptr, indices = Ssym.indptr, Ssym.indices
    for i in range(n):
        mark[i] = i
        for p in range(int(indptr[i]), int(indptr[i + 1])):
            k = int(indices[p])
            if k >= i:
                continue
            while mark[k] != i:
                mark[k] = i
                Lpat[k].append(i)
                if parent[k] == -1:
                    parent[k] = i
                k = int(parent[k])
    Pi, Pj = [], []
    for j in range(n):
        cols = [j] + Lpat[j]
        Pi.extend(cols)
        Pj.extend([j] * len(cols))
    Pat = sp.csc_matrix((np.ones(len(Pi)), (Pi, Pj)), shape=(n, n))
    Pat = ((Pat + Pat.T) != 0).tocsc()
    Pat.sort_indices()

    # Takahashi backward sweep with a dense accumulator column (host tool;
    # cost O(sum_j |patcol_j| * |Ucol/Lcol|))
    Zcols = [None] * n
    Zcol_rows = [Pat.indices[Pat.indptr[j]:Pat.indptr[j + 1]]
                 for j in range(n)]
    zfind = [dict((int(r), t) for t, r in enumerate(Zcol_rows[j]))
             for j in range(n)]

    def zget(i, j):
        """Z[i,j] with symmetry of the PATTERN only (values differ for
        unsymmetric A) — entries are stored per column."""
        t = zfind[j].get(i)
        return Zcols[j][t] if t is not None else 0.0

    for j in range(n - 1, -1, -1):
        rows = Zcol_rows[j]
        z = np.zeros(len(rows))
        # diagonal: Z[j,j] = 1/d_j - sum_k U[j,k] Z[k,j]  (k > j)
        # but Z[k,j] for k>j is in THIS column and depends on Z[:,k>j]
        # (already computed).  Compute lower part top-down? The lower
        # recurrence Z[i,j] = -sum_{k>j} Z[i,k] L[k,j] uses only later
        # columns -> compute all i > j first, then the diagonal, then
        # the upper part i < j via Z[i,j] = -sum_{k>i} U[i,k] Z[k,j]
        # (k > i >= ... k can be <= j or > j; entries Z[k,j] with k > i
        # are later in THIS column — iterate i descending).
        lk = Li[Lp[j]:Lp[j + 1]]
        lx = Lx[Lp[j]:Lp[j + 1]]
        for t in range(len(rows) - 1, -1, -1):
            i = int(rows[t])
            if i > j:
                acc = 0.0
                for s in range(len(lk)):
                    acc -= zget(i, int(lk[s])) * lx[s]
                z[t] = acc
            elif i == j:
                acc = 1.0 / d[j]
                uk = Urow_j[j]
                ux = Urow_x[j]
                for s in range(len(uk)):
                    tt = zfind[j].get(int(uk[s]))
                    if tt is not None:
                        acc -= ux[s] * z[tt]
                z[t] = acc
            else:
                acc = 0.0
                uk = Urow_j[i]
                ux = Urow_x[i]
                for s in range(len(uk)):
                    k = int(uk[s])
                    tt = zfind[j].get(k)
                    if tt is not None:        # closure: always hits
                        acc -= ux[s] * z[tt]
                z[t] = acc
        Zcols[j] = z

    # map back to A coordinates: klu solves x = Q C^{-1} P (b/Rs), so
    # inv(A)[q[i], pf[j]] = Z[i, j] / Rs[pf[j]]
    q = np.asarray(sym.q)
    pf = np.asarray(num.p_final)
    Rs = np.asarray(num.Rs)
    rowsI, colsJ, vals = [], [], []
    for j in range(n):
        rows = Zcol_rows[j]
        gj = int(pf[j])
        rowsI.append(q[rows])
        colsJ.append(np.full(len(rows), gj, dtype=INDEX))
        vals.append(Zcols[j] / Rs[gj])
    Zi = np.concatenate(rowsI)
    Zj = np.concatenate(colsJ)
    Zv = np.concatenate(vals)
    Z = sp.csc_matrix((Zv, (Zi, Zj)), shape=(n, n))
    Zpattern = sp.csc_matrix(
        (np.ones(len(Zi), bool), (Zi, Zj)), shape=(n, n))
    return Z.tocsc(), Zpattern.tocsc()
