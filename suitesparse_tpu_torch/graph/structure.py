"""Symbolic-analysis graph kernels: elimination trees, postorder, counts, reach.

Equivalents of cholmod_etree / cholmod_postorder / cholmod_rowcolcounts
(CHOLMOD/Cholesky) and cs_etree / cs_post / cs_counts / cs_reach /
cs_ereach (CSparse).  These run once per sparsity pattern on the host
(O(nnz·α) work), so they are NumPy/Python; hot ones also have C++
twins in native/ dispatched via suitesparse_tpu.graph.native.

All functions take CSC arrays directly (indptr/indices) to stay
allocation-light; -1 encodes "no parent"/"empty".
"""
from __future__ import annotations

import numpy as np

from ..core.sparse import INDEX, SparseCSC


def etree(A: SparseCSC, col: bool = False) -> np.ndarray:
    """Elimination tree of A (upper triangle used) or of A'A if col=True.

    Liu's algorithm with path-halving ancestor compression
    (reference behavior: CHOLMOD/Cholesky/cholmod_etree.c, cs_etree).
    """
    n = A.ncol
    indptr, indices = A.indptr, A.indices
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "sstpu_etree"):
        parent = np.empty(n, dtype=INDEX)
        lib.sstpu_etree(n, A.nrow, np.ascontiguousarray(indptr),
                        np.ascontiguousarray(indices), int(col), parent)
        return parent
    parent = np.full(n, -1, dtype=INDEX)
    ancestor = np.full(n, -1, dtype=INDEX)
    prev = np.full(A.nrow, -1, dtype=INDEX) if col else None
    for k in range(n):
        for p in range(indptr[k], indptr[k + 1]):
            r = int(indices[p])
            if col:
                i = int(prev[r])     # last column seen in row r
                prev[r] = k
            else:
                i = r                # entries with i >= k are skipped below
            while i != -1 and i < k:
                nxt = int(ancestor[i])
                ancestor[i] = k
                if nxt == -1:
                    parent[i] = k
                    break
                i = nxt
    return parent


def postorder(parent: np.ndarray, weights: np.ndarray | None = None) -> np.ndarray:
    """Postorder a forest; children visited in order (optionally by weight,
    the cholmod_postorder weighted variant used to keep big children last).

    Returns post such that post[k] = node visited k-th.  Non-recursive DFS
    (reference: cholmod_postorder.c, cs_post/cs_tdfs).
    """
    n = len(parent)
    if weights is None:
        from ..utils.native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "sstpu_postorder"):
            post = np.empty(n, dtype=INDEX)
            lib.sstpu_postorder(n, np.ascontiguousarray(parent, dtype=INDEX),
                                post)
            return post
    # build child lists (head/next), children pushed so iteration order is
    # by decreasing node index -> natural ordering preserved on pop
    head = np.full(n, -1, dtype=INDEX)
    next_ = np.full(n, -1, dtype=INDEX)
    order = np.arange(n - 1, -1, -1)
    if weights is not None:
        # visit small-weight children first => push large-weight last
        order = np.argsort(weights, kind="stable")[::-1]
    for j in order:
        p = parent[j]
        if p != -1:
            next_[j] = head[p]
            head[p] = j
    post = np.empty(n, dtype=INDEX)
    stack = np.empty(n, dtype=INDEX)
    k = 0
    for root in range(n):
        if parent[root] != -1:
            continue
        top = 0
        stack[0] = root
        while top >= 0:
            node = int(stack[top])
            child = int(head[node])
            if child == -1:
                post[k] = node
                k += 1
                top -= 1
            else:
                head[node] = next_[child]
                top += 1
                stack[top] = child
    return post


def ereach(A: SparseCSC, k: int, parent: np.ndarray,
           work: np.ndarray | None = None) -> np.ndarray:
    """Nonzero pattern of row k of L (up-looking row subtree traversal,
    cs_ereach / cholmod row_subtree).  A: upper-stored symmetric pattern."""
    n = A.ncol
    w = work if work is not None else np.zeros(n, dtype=bool)
    stack = []
    out = []
    w[k] = True
    for p in range(A.indptr[k], A.indptr[k + 1]):
        i = int(A.indices[p])
        if i > k:
            continue
        path = []
        while not w[i]:
            path.append(i)
            w[i] = True
            i = int(parent[i])
        out.extend(reversed(path))
        stack.extend(path)
    for i in stack:
        w[i] = False
    w[k] = False
    # out currently holds nodes in per-path root-to-leaf... sort ascending:
    return np.sort(np.array(out, dtype=INDEX))


def col_counts(A: SparseCSC, parent: np.ndarray, post: np.ndarray) -> np.ndarray:
    """nnz per column of the Cholesky factor L of A (A symmetric, upper
    stored).  Simple O(n·avg_rowsubtree) version via row subtrees — exact,
    used as oracle; the fast Gilbert-Ng-Peyton version lives in native/.
    (reference: cholmod_rowcolcounts.c, cs_counts)."""
    n = A.ncol
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "sstpu_colcounts"):
        counts = np.empty(n, dtype=INDEX)
        lib.sstpu_colcounts(n, np.ascontiguousarray(A.indptr),
                            np.ascontiguousarray(A.indices),
                            np.ascontiguousarray(parent, dtype=INDEX), counts)
        return counts
    counts = np.ones(n, dtype=INDEX)   # diagonal
    w = np.zeros(n, dtype=bool)
    for k in range(n):
        for i in ereach(A, k, parent, w):
            counts[i] += 1
    return counts


def row_counts_from_colpattern(Lp, Li, n) -> np.ndarray:
    counts = np.zeros(n, dtype=INDEX)
    np.add.at(counts, Li, 1)
    return counts


def chol_symbolic_flops(col_counts_: np.ndarray) -> float:
    """flops for LL' numeric factorization given column counts of L:
    sum_j cc[j]^2 (the fl statistic in cholmod_analyze; used by the
    supernodal_switch and ordering-quality metrics)."""
    cc = col_counts_.astype(np.float64)
    return float(np.sum(cc * cc))


def reach(Gp, Gi, Bp, Bi, k: int, pinv: np.ndarray | None = None) -> np.ndarray:
    """Nodes reachable in graph of G (CSC, edges j->Gi[p]) from pattern of
    B(:,k) — the sparse-triangular-solve pattern x = L\\b (cs_reach).
    Returns topologically ordered node list (reverse DFS finish order)."""
    n = len(Gp) - 1
    marked = np.zeros(n, dtype=bool)
    out: list[int] = []
    # iterative DFS with explicit position stack
    pstack = np.zeros(n + 1, dtype=INDEX)
    for pb in range(Bp[k], Bp[k + 1]):
        root = int(Bi[pb])
        if marked[root]:
            continue
        stack = [root]
        pstack[0] = 0
        marked[root] = True
        while stack:
            j = stack[-1]
            jj = int(pinv[j]) if pinv is not None else j
            lo = int(Gp[jj]) if jj != -1 else 0
            hi = int(Gp[jj + 1]) if jj != -1 else 0
            p = int(pstack[len(stack) - 1])
            descended = False
            while lo + p < hi:
                i = int(Gi[lo + p])
                p += 1
                if not marked[i]:
                    pstack[len(stack) - 1] = p
                    stack.append(i)
                    pstack[len(stack) - 1] = 0
                    marked[i] = True
                    descended = True
                    break
            if not descended:
                stack.pop()
                out.append(j)
    return np.array(out[::-1], dtype=INDEX)


def tree_levels(parent: np.ndarray) -> np.ndarray:
    """Level (distance from root) of each node; roots at level 0."""
    n = len(parent)
    level = np.full(n, -1, dtype=INDEX)
    for j in range(n):
        # walk up until a node with known level, then unwind
        path = []
        i = j
        while i != -1 and level[i] == -1:
            path.append(i)
            i = int(parent[i])
        base = 0 if i == -1 else int(level[i]) + 1
        for d, node in enumerate(reversed(path)):
            level[node] = base + d
    return level


def tree_depth_below(parent: np.ndarray) -> np.ndarray:
    """Height of the subtree rooted at each node (leaves = 0)."""
    n = len(parent)
    h = np.zeros(n, dtype=INDEX)
    for j in range(n):
        p = int(parent[j])
        if p != -1 and h[j] + 1 > h[p]:
            h[p] = h[j] + 1
    return h


def firstdesc(parent: np.ndarray, post: np.ndarray) -> np.ndarray:
    """First descendant of each node in postorder (used by GNP counts)."""
    n = len(parent)
    first = np.full(n, -1, dtype=INDEX)
    for k in range(n):
        j = int(post[k])
        r = j
        while r != -1 and first[r] == -1:
            first[r] = k
            r = int(parent[r])
    return first
