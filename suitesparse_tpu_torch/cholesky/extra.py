"""CHOLMOD Cholesky-module extras: sparse-RHS solves, subset solves,
resymbol, row subtree solves.

Counterpart of suitesparse_tpu/cholesky/extra.py, copied (host NumPy in
both packages).

Reference: cholmod_spsolve (sparse B), cholmod_solve2 (reused workspace +
sparse Bset subset solve, cholmod_solve.c:1032), cholmod_resymbol,
cholmod_row_subtree / lsolve_pattern.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.sparse import INDEX, SparseCSC, Triplet, invert_permutation
from ..graph import ereach, reach
from .simplicial import Factor, solve


def spsolve(f: Factor, B: SparseCSC, system: str = "A") -> SparseCSC:
    """cholmod_spsolve: X = A \\ B with sparse B, sparse X out."""
    n = f.n
    cols = []
    rows_all, cols_all, vals_all = [], [], []
    for k in range(B.ncol):
        lo, hi = int(B.indptr[k]), int(B.indptr[k + 1])
        b = np.zeros(n)
        b[B.indices[lo:hi]] = B.data[lo:hi]
        x = solve(f, b, system)
        nz = np.nonzero(x)[0]
        rows_all.append(nz)
        cols_all.append(np.full(len(nz), k, dtype=INDEX))
        vals_all.append(x[nz])
    if rows_all:
        return Triplet(np.concatenate(rows_all), np.concatenate(cols_all),
                       np.concatenate(vals_all), (n, B.ncol)).to_csc()
    return SparseCSC(np.zeros(B.ncol + 1, dtype=INDEX),
                     np.empty(0, dtype=INDEX), np.empty(0), (n, B.ncol))


def lsolve_pattern(f: Factor, B: SparseCSC, k: int = 0) -> np.ndarray:
    """cholmod_lsolve_pattern: nonzero pattern of L \\ B(:,k) via reach
    (in permuted coordinates)."""
    pinv = invert_permutation(f.perm)
    lo, hi = int(B.indptr[k]), int(B.indptr[k + 1])
    rows = np.sort(pinv[B.indices[lo:hi]])
    Bp = np.array([0, len(rows)], dtype=INDEX)
    return reach(f.Lp, f.Li, Bp, rows, 0)


def solve2(f: Factor, b: np.ndarray, bset: Optional[np.ndarray] = None,
           system: str = "A") -> tuple[np.ndarray, Optional[np.ndarray]]:
    """cholmod_solve2: solve for a *subset* of b's entries / solution.

    With bset (sorted row indices where b is nonzero), only the parts of
    the triangular solves reachable from bset are computed, returning
    (x, xset) with xset = the nonzero pattern of x (cholmod_solve.c:1032).
    Without bset this is a plain solve.
    """
    if bset is None:
        return solve(f, b, system), None
    n = f.n
    pinv = invert_permutation(f.perm)
    prows = np.sort(pinv[np.asarray(bset, dtype=INDEX)])
    Bp = np.array([0, len(prows)], dtype=INDEX)
    patt = reach(f.Lp, f.Li, Bp, prows, 0)        # forward pattern
    # sparse forward solve restricted to patt
    x = np.zeros(n)
    x[pinv[np.asarray(bset)]] = np.asarray(b)[np.asarray(bset)]
    for j in patt:
        j = int(j)
        lo, hi = int(f.Lp[j]), int(f.Lp[j + 1])
        if f.is_ll:
            x[j] /= f.Lx[lo]
        xj = x[j]
        x[f.Li[lo + 1:hi]] -= f.Lx[lo + 1:hi] * xj
    if not f.is_ll:
        x[patt] = x[patt] / f.D[patt]
    # backward solve restricted to the ancestor closure of patt: the
    # pattern of L'\y is the set of ancestors; for subset solves CHOLMOD
    # computes the full upward closure
    marked = np.zeros(n, dtype=bool)
    marked[patt] = True
    # up-solve over columns that can reach the pattern: iterate descending
    for j in range(n - 1, -1, -1):
        lo, hi = int(f.Lp[j]), int(f.Lp[j + 1])
        rows = f.Li[lo + 1:hi]
        if marked[j] or (len(rows) and marked[rows].any()):
            marked[j] = True
            contrib = np.dot(f.Lx[lo + 1:hi], x[rows]) if len(rows) else 0.0
            x[j] -= contrib
            if f.is_ll:
                x[j] /= f.Lx[lo]
    xset_perm = np.where(marked)[0]
    out = np.zeros(n)
    out[f.perm[xset_perm]] = x[xset_perm]
    xset = np.sort(f.perm[xset_perm])
    return out, xset


def resymbol(A: SparseCSC, f: Factor, common=None) -> Factor:
    """cholmod_resymbol: recompute the symbolic pattern of the factor for
    (possibly pruned) A, dropping entries outside the new pattern."""
    from .symbolic import analyze
    from .simplicial import factorize_simplicial
    sym = analyze(A, common, perm=f.perm)
    return factorize_simplicial(A, sym, common, ll=f.is_ll)


def row_subtree(A: SparseCSC, k: int, parent: np.ndarray) -> np.ndarray:
    """cholmod_row_subtree: pattern of row k of L (ereach)."""
    return ereach(A, k, parent)
