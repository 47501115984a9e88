"""AMD / CAMD: (constrained) approximate minimum degree ordering.

API parity with the reference (AMD/Include/amd.h:50-62, CAMD camd.h):
``amd(A)`` orders the pattern of A+A'; ``camd(A, cmember)`` respects
constraint sets.  Implementation is the native C++ component
(native/src/amd.cc, the task-mandated native path); a pure-Python exact
minimum-degree fallback keeps the package functional without a toolchain.

Info dict parity with AMD_INFO (amd.h:233-337): lnz estimate, ndiv/nmultsubs
counts derivable from the symbolic factorization of the ordered pattern.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.common import Common
from ..core.sparse import INDEX, SparseCSC, SYM_LOWER, UNSYM
from ..core.status import SparseError, Status
from ..utils.native import get_lib


def _symmetric_pattern_nodiag(A: SparseCSC) -> tuple[np.ndarray, np.ndarray]:
    """CSC pattern of A+A' without the diagonal (what amd_order builds via
    AMD_aat, amd_order.c:141)."""
    n = A.ncol
    if A.nrow != n:
        raise SparseError(Status.INVALID, "amd requires a square matrix")
    col = np.repeat(np.arange(n, dtype=INDEX), np.diff(A.indptr))
    row = A.indices
    off = row != col
    r, c = row[off], col[off]
    # symmetrize
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    # dedupe
    order = np.lexsort((rr, cc))
    rr, cc = rr[order], cc[order]
    if len(rr):
        keep = np.empty(len(rr), dtype=bool)
        keep[0] = True
        keep[1:] = (rr[1:] != rr[:-1]) | (cc[1:] != cc[:-1])
        rr, cc = rr[keep], cc[keep]
    indptr = np.zeros(n + 1, dtype=INDEX)
    np.add.at(indptr, cc + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, np.ascontiguousarray(rr)


def amd(A: SparseCSC, common: Optional[Common] = None,
        dense: Optional[float] = None, aggressive: Optional[bool] = None) -> np.ndarray:
    """Fill-reducing ordering of A+A'.  Returns perm with perm[k] = k-th pivot
    (amd_order convention, amd.h:50-62)."""
    return _amd_impl(A, None, common, dense, aggressive)


def camd(A: SparseCSC, cmember: np.ndarray, common: Optional[Common] = None,
         dense: Optional[float] = None, aggressive: Optional[bool] = None) -> np.ndarray:
    """Constrained AMD: nodes in lower-numbered constraint sets are ordered
    first; sets stay contiguous (camd_order semantics)."""
    cmember = np.ascontiguousarray(cmember, dtype=INDEX)
    if len(cmember) != A.ncol:
        raise SparseError(Status.INVALID, "cmember length mismatch")
    return _amd_impl(A, cmember, common, dense, aggressive)


def _amd_impl(A, cmember, common, dense, aggressive) -> np.ndarray:
    cm = common
    opts = cm.cholesky if cm is not None else None
    dense_t = dense if dense is not None else (opts.amd_dense if opts else 10.0)
    aggr = aggressive if aggressive is not None else (opts.amd_aggressive if opts else True)
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=INDEX)
    indptr, indices = _symmetric_pattern_nodiag(A)
    lib = get_lib()
    if lib is not None:
        perm = np.empty(n, dtype=INDEX)
        cptr = cmember.ctypes.data_as(__import__("ctypes").c_void_p) if cmember is not None else None
        lib.sstpu_amd(n, indptr, indices, perm, cptr, float(dense_t), int(bool(aggr)))
        if sorted(perm.tolist()) != list(range(n)):  # safety: invalid output
            if cm is not None:
                cm.status = Status.INVALID
            raise SparseError(Status.INVALID, "native amd returned invalid permutation")
        return perm
    return _amd_python(indptr, indices, n, cmember)


def _amd_python(indptr, indices, n, cmember=None) -> np.ndarray:
    """Fallback: exact-external-degree minimum degree with quotient graph,
    no supervariables (small-problem use only)."""
    import heapq

    adj = [set(indices[indptr[j]:indptr[j + 1]].tolist()) for j in range(n)]
    alive = np.ones(n, dtype=bool)
    heap = [( (0 if cmember is None else int(cmember[j])), len(adj[j]), j) for j in range(n)]
    heapq.heapify(heap)
    perm = []
    indeg = {j: len(adj[j]) for j in range(n)}
    while heap:
        c, d, j = heapq.heappop(heap)
        if not alive[j] or d != indeg[j]:
            continue
        perm.append(j)
        alive[j] = False
        nbrs = [v for v in adj[j] if alive[v]]
        for v in nbrs:
            adj[v].discard(j)
            for u in nbrs:
                if u != v:
                    adj[v].add(u)
            indeg[v] = len(adj[v])
            heapq.heappush(heap, ((0 if cmember is None else int(cmember[v])),
                                  indeg[v], v))
    return np.array(perm, dtype=INDEX)


def amd_valid(n: int, perm: np.ndarray) -> bool:
    """amd_valid: is perm a permutation of 0..n-1."""
    return len(perm) == n and sorted(np.asarray(perm).tolist()) == list(range(n))


def amd_info(A: SparseCSC, perm: np.ndarray) -> dict:
    """AMD Info analog (amd.h:233-337): symbolic stats of the ordered factor
    — lnz, flop counts for LDL'/LU, max front-ish column count."""
    from ..graph import chol_symbolic_flops, col_counts, etree, postorder
    from ..io.generators import symmetrize_upper

    S = A if A.stype > 0 else symmetrize_upper(A)
    P = S.symperm(perm, values=False)
    parent = etree(P)
    post = postorder(parent)
    cc = col_counts(P, parent, post)
    lnz = int(cc.sum()) - A.ncol   # strictly-below-diagonal entries
    fl = chol_symbolic_flops(cc)
    return {
        "n": A.ncol,
        "lnz": lnz,
        "ndiv": lnz,
        "fl_chol": fl,
        "dmax": int(cc.max()) if len(cc) else 0,
    }
