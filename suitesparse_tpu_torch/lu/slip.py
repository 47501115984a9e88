"""SLIP_LU-class exact rational sparse LU.

Reference: SLIP_LU (SURVEY.md §2 item 26) — roundoff-free solution of
Ax=b over the rationals using GMP/MPFR, left-looking sparse LU with
COLAMD/AMD ordering and configurable pivot schemes.

Counterpart of suitesparse_tpu/lu/slip.py, copied.  Exact integer
arithmetic has no device mapping, so like the reference (which runs on
CPU via GMP) this is a host component.  We run left-looking
Gilbert-Peierls elimination over Python Fractions (arbitrary-precision
rationals — the GMP mpq stand-in).  Floats convert to Fractions
exactly (binary rationals), so "exact" means exact: the returned solution
satisfies Ax=b with zero residual.
Pivot schemes: 'smallest' (default), 'diagonal', 'largest', 'first'
(SLIP_LU.h pivot scheme subset).
"""
from __future__ import annotations

import heapq
from fractions import Fraction
from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import SparseCSC
from ..core.status import SparseError, Status


def slip_lu_analyze(A: SparseCSC, common: Optional[Common] = None,
                    ordering: str = "colamd") -> np.ndarray:
    """SLIP_LU_analyze: column preorder (none/colamd/amd, SLIP_LU.h)."""
    if ordering == "none":
        return np.arange(A.ncol, dtype=np.int64)
    from ..ordering import amd, colamd
    return (colamd if ordering == "colamd" else amd)(A, common)


def slip_lu_factorize(A: SparseCSC, q: np.ndarray,
                      common: Optional[Common] = None,
                      pivot: str = "smallest"):
    """Exact sparse left-looking LU of A(:, q) over the rationals.

    Returns (Lcols, Udiag, Ucols, rowperm): per elimination step k,
    Lcols[k] = {row: multiplier} (exact Fractions), Ucols[k] = {j: u_jk},
    Udiag[k] = pivot, rowperm[k] = pivot row.
    """
    cm = common or default_common()
    n = A.ncol
    if A.nrow != n:
        raise SparseError(Status.INVALID, "slip needs a square matrix")
    Ap = A.permute(None, q)
    pinv = np.full(n, -1, dtype=np.int64)    # row -> pivot step
    rowperm = np.full(n, -1, dtype=np.int64)
    Lcols: list[dict] = []
    Udiag: list[Fraction] = []
    Ucols: list[dict] = []
    for k in range(n):
        lo, hi = int(Ap.indptr[k]), int(Ap.indptr[k + 1])
        x = {int(Ap.indices[p]): Fraction(Ap.data[p].item())
             for p in range(lo, hi)}
        # left-looking elimination in ascending pivot order; fills only ever
        # introduce later pivots, so a heap gives a valid topological order
        heap = []
        inheap = set()
        for r in x:
            j = int(pinv[r])
            if j >= 0 and j not in inheap:
                heapq.heappush(heap, j)
                inheap.add(j)
        ucol: dict[int, Fraction] = {}
        while heap:
            j = heapq.heappop(heap)
            pr = int(rowperm[j])
            xj = x.get(pr, Fraction(0))
            if xj == 0:
                continue
            ucol[j] = xj
            del x[pr]
            for r, lv in Lcols[j].items():
                xr = x.get(r, Fraction(0)) - lv * xj
                if xr == 0:
                    x.pop(r, None)
                    continue
                x[r] = xr
                jj = int(pinv[r])
                if jj >= 0 and jj not in inheap:
                    heapq.heappush(heap, jj)
                    inheap.add(jj)
        live = {r: v for r, v in x.items() if pinv[r] < 0 and v != 0}
        if not live:
            cm.status = Status.SINGULAR
            raise SparseError(Status.SINGULAR, f"exactly singular at col {k}")
        if pivot == "diagonal" and k in live:
            pr = k
        elif pivot == "first":
            pr = min(live)
        elif pivot == "largest":
            pr = max(live, key=lambda r: abs(live[r]))
        else:
            pr = min(live, key=lambda r: (abs(live[r]), r))
        piv = live.pop(pr)
        rowperm[k] = pr
        pinv[pr] = k
        Udiag.append(piv)
        Ucols.append(ucol)
        Lcols.append({r: v / piv for r, v in live.items()})
    cm.status = Status.OK
    return Lcols, Udiag, Ucols, rowperm


def slip_lu_solve(factors, q: np.ndarray, b) -> list:
    """Exact solve with the factors from slip_lu_factorize."""
    Lcols, Udiag, Ucols, rowperm = factors
    n = len(Udiag)
    b = np.asarray(b)
    one_d = b.ndim == 1
    B = b.reshape(n, -1)
    nrhs = B.shape[1]
    bb = [[Fraction(B[i, kk].item()) for kk in range(nrhs)] for i in range(n)]
    # forward: y_k = b[rowperm[k]] after eliminations
    y = [[Fraction(0)] * nrhs for _ in range(n)]
    for k in range(n):
        pr = int(rowperm[k])
        for kk in range(nrhs):
            y[k][kk] = bb[pr][kk] / Udiag[k]
        for r, lv in Lcols[k].items():
            for kk in range(nrhs):
                bb[r][kk] -= lv * (y[k][kk] * Udiag[k])
    # backward: U is unit-diagonal in this scaling?  u_kk folded into y;
    # solve (D^-1 U) x = y with unit diagonal: x_k = y_k - sum u_jk'...
    xq = [[Fraction(0)] * nrhs for _ in range(n)]
    for k in range(n - 1, -1, -1):
        for kk in range(nrhs):
            acc = y[k][kk]
            xq[k][kk] = acc
    # substitute U couplings: Ucols[k][j] = u_{j,k} couples x_k into row j
    for k in range(n - 1, -1, -1):
        for j, ujk in Ucols[k].items():
            for kk in range(nrhs):
                xq[j][kk] -= (ujk / Udiag[j]) * xq[k][kk]
    x = [[Fraction(0)] * nrhs for _ in range(n)]
    for k in range(n):
        x[int(q[k])] = xq[k]
    if one_d:
        return [x[i][0] for i in range(n)]
    return x


def slip_backslash(A: SparseCSC, b, common: Optional[Common] = None,
                   ordering: str = "colamd", pivot: str = "smallest"):
    """SLIP_backslash: exact rational x with Ax=b (zero residual)."""
    cm = common or default_common()
    q = slip_lu_analyze(A, cm, ordering)
    factors = slip_lu_factorize(A, q, cm, pivot)
    return slip_lu_solve(factors, q, b)
