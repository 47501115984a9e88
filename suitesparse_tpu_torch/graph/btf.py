"""Block-triangular form: maximum transversal, strongly connected
components, and Dulmage-Mendelsohn decomposition.

Equivalents of BTF (btf_maxtrans/btf_strongcomp/btf_order,
BTF/Include/btf.h:100-212) and CSparse cs_maxtrans/cs_scc/cs_dmperm.
Host-side pointer algorithms; the hot maxtrans/scc also have C++ twins
in native/.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.sparse import INDEX, SparseCSC, invert_permutation


def maxtrans(A: SparseCSC, maxwork: float = -1.0) -> tuple[np.ndarray, int]:
    """Maximum matching of columns to rows (zero-free diagonal permutation).

    Returns (match, nmatch): match[j] = row matched to column j, -1 if
    unmatched.  Augmenting-path (MC21-style) with cheap-assignment first,
    like btf_maxtrans (BTF/Source/btf_maxtrans.c).  maxwork < 0 means no
    work limit (btf.h maxwork semantics).
    """
    n, m = A.ncol, A.nrow
    Ap, Ai = A.indptr, A.indices
    match = np.full(n, -1, dtype=INDEX)      # col -> row
    rmatch = np.full(m, -1, dtype=INDEX)     # row -> col
    # cheap assignment pass
    cheap = Ap[:-1].copy()
    for j in range(n):
        for p in range(Ap[j], Ap[j + 1]):
            i = int(Ai[p])
            if rmatch[i] == -1:
                match[j] = i
                rmatch[i] = j
                break
    work = 0
    limit = maxwork * A.nnz if maxwork > 0 else np.inf
    visited = np.full(m, -1, dtype=INDEX)    # stamp = column being augmented
    # iterative augmenting path DFS over columns
    jstack = np.empty(n + 1, dtype=INDEX)
    pstack = np.empty(n + 1, dtype=INDEX)
    istack = np.empty(n + 1, dtype=INDEX)
    for j0 in range(n):
        if match[j0] != -1:
            continue
        if work > limit:
            break
        found = False
        head = 0
        jstack[0] = j0
        pstack[0] = Ap[j0]
        while head >= 0:
            j = int(jstack[head])
            # cheap scan: any unmatched row in column j?
            if int(cheap[j]) < int(Ap[j + 1]):
                p = int(cheap[j])
                while p < Ap[j + 1]:
                    i = int(Ai[p])
                    if rmatch[i] == -1:
                        break
                    p += 1
                cheap[j] = p
                if p < Ap[j + 1]:
                    ifree = int(Ai[p])
                    found = True
                    break
            # deep scan: follow matched rows
            descended = False
            p = int(pstack[head])
            while p < Ap[j + 1]:
                i = int(Ai[p])
                work += 1
                p += 1
                if visited[i] == j0:
                    continue
                visited[i] = j0
                pstack[head] = p
                head += 1
                jstack[head] = rmatch[i]
                pstack[head] = Ap[int(rmatch[i])]
                istack[head] = i
                descended = True
                break
            if not descended:
                head -= 1
        if found:
            # augment: top column takes the free row; each column below takes
            # the matched row through which the DFS descended into the column
            # above it (istack[h] = row entered jstack[h] via)
            i = ifree
            for h in range(head, -1, -1):
                j = int(jstack[h])
                match[j] = i
                rmatch[i] = j
                i = int(istack[h])
    return match, int((match != -1).sum())


def strongcomp(Ap, Ai, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Strongly connected components by iterative Tarjan DFS.

    Returns (p, rblocks): p is a permutation putting the graph in block
    upper triangular form, rblocks the block boundaries (len nblocks+1).
    Matches btf_strongcomp's output convention (BTF/Source/btf_strongcomp.c:
    non-recursive Tarjan, blocks in topological order along the diagonal).
    """
    index = np.full(n, -1, dtype=INDEX)
    low = np.zeros(n, dtype=INDEX)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=INDEX)
    tstack: list[int] = []
    counter = 0
    ncomp = 0
    # iterative Tarjan
    call_j = np.empty(n + 1, dtype=INDEX)
    call_p = np.empty(n + 1, dtype=INDEX)
    for root in range(n):
        if index[root] != -1:
            continue
        head = 0
        call_j[0] = root
        call_p[0] = Ap[root]
        index[root] = low[root] = counter
        counter += 1
        tstack.append(root)
        on_stack[root] = True
        while head >= 0:
            j = int(call_j[head])
            p = int(call_p[head])
            advanced = False
            while p < Ap[j + 1]:
                i = int(Ai[p])
                p += 1
                if index[i] == -1:
                    call_p[head] = p
                    head += 1
                    call_j[head] = i
                    call_p[head] = Ap[i]
                    index[i] = low[i] = counter
                    counter += 1
                    tstack.append(i)
                    on_stack[i] = True
                    advanced = True
                    break
                elif on_stack[i]:
                    if index[i] < low[j]:
                        low[j] = index[i]
            if advanced:
                continue
            # finished j
            if low[j] == index[j]:
                while True:
                    w = tstack.pop()
                    on_stack[w] = False
                    comp[w] = ncomp
                    if w == j:
                        break
                ncomp += 1
            head -= 1
            if head >= 0:
                pj = int(call_j[head])
                if low[j] < low[pj]:
                    low[pj] = low[j]
    # Tarjan pops a component only after every component reachable from it:
    # edge j->i (entry in block (comp[i], comp[j])) implies comp[i] <= comp[j],
    # so pop order directly yields block upper triangular form.
    order = np.argsort(comp, kind="stable")
    rblocks = np.zeros(ncomp + 1, dtype=INDEX)
    np.add.at(rblocks, comp + 1, 1)
    np.cumsum(rblocks, out=rblocks)
    return order.astype(INDEX), rblocks


@dataclasses.dataclass
class BTFResult:
    """btf_order output: permutations P, Q with PAQ block upper triangular."""

    p: np.ndarray          # row permutation
    q: np.ndarray          # column permutation
    r: np.ndarray          # block boundaries, len nblocks+1
    nmatch: int            # structural rank (size of max matching)

    @property
    def nblocks(self) -> int:
        return len(self.r) - 1


def btf_order(A: SparseCSC, maxwork: float = -1.0) -> BTFResult:
    """Permutation to block upper triangular form (btf_order, btf.h:202-212):
    max transversal then SCC of the matched graph.  Structurally singular
    matrices get unmatched columns flushed to the end (partial match
    handling as in btf_maxtrans)."""
    n = A.ncol
    assert A.nrow == n, "btf_order requires a square matrix"
    match, nmatch = maxtrans(A, maxwork)
    if nmatch < n:
        # complete the match arbitrarily so PA has a zero-free diagonal where
        # possible (unmatched rows/cols paired in order, as btf_order does)
        unmatched_rows = np.setdiff1d(np.arange(n, dtype=INDEX), match[match != -1])
        k = 0
        for j in range(n):
            if match[j] == -1:
                match[j] = unmatched_rows[k]
                k += 1
    # B = A with rows permuted so diagonal is the matching: B[j -> match[j]]
    # graph for SCC: column j has edges to columns rmatch-of-each-row
    rmatch = invert_permutation(match)
    # build adjacency: col j -> cols rmatch[Ai[p]]
    Bp = A.indptr
    Bi = rmatch[A.indices]
    q_order, rblocks = strongcomp(Bp, Bi, n)
    q = q_order
    p = match[q]
    return BTFResult(p=p.astype(INDEX), q=q.astype(INDEX), r=rblocks, nmatch=nmatch)


@dataclasses.dataclass
class DMPermResult:
    """cs_dmperm-style coarse+fine Dulmage-Mendelsohn decomposition."""

    p: np.ndarray
    q: np.ndarray
    r: np.ndarray          # fine row block boundaries
    s: np.ndarray          # fine col block boundaries
    cc: np.ndarray         # coarse column boundaries, len 5
    rr: np.ndarray         # coarse row boundaries, len 5
    structural_rank: int


def dmperm(A: SparseCSC) -> DMPermResult:
    """Dulmage-Mendelsohn decomposition (cs_dmperm).

    Coarse: split into underdetermined [A11 A12], square well-determined
    A23 part, overdetermined [A34; A44]; fine: SCCs of the square part.
    """
    m, n = A.shape
    match, nmatch = maxtrans(A)          # col -> row
    rmatch = np.full(m, -1, dtype=INDEX)
    for j in range(n):
        if match[j] != -1:
            rmatch[match[j]] = j

    # C1: unmatched columns + cols reachable from them via alternating paths
    # (col -> any row -> matched col).  Mark via BFS.
    colmark = np.zeros(n, dtype=bool)
    rowmark_h = np.zeros(m, dtype=bool)
    queue = [j for j in range(n) if match[j] == -1]
    for j in queue:
        colmark[j] = True
    while queue:
        j = queue.pop()
        for p in range(A.indptr[j], A.indptr[j + 1]):
            i = int(A.indices[p])
            if rowmark_h[i]:
                continue
            rowmark_h[i] = True
            j2 = int(rmatch[i])
            if j2 != -1 and not colmark[j2]:
                colmark[j2] = True
                queue.append(j2)
    # V1: unmatched rows + rows reachable via alternating row paths
    rowmark_v = np.zeros(m, dtype=bool)
    colmark_v = np.zeros(n, dtype=bool)
    # need row-wise adjacency: transpose
    AT = A.transpose(values=False)
    queue = [i for i in range(m) if rmatch[i] == -1]
    for i in queue:
        rowmark_v[i] = True
    while queue:
        i = queue.pop()
        for p in range(AT.indptr[i], AT.indptr[i + 1]):
            j = int(AT.indices[p])
            if colmark_v[j]:
                continue
            colmark_v[j] = True
            i2 = int(match[j])
            if i2 != -1 and not rowmark_v[i2]:
                rowmark_v[i2] = True
                queue.append(i2)

    # coarse sets
    C1 = np.where(colmark)[0]                            # horizontal cols
    R1 = np.where(rowmark_h)[0]                          # horizontal rows
    C3 = np.where(colmark_v)[0]                          # vertical cols
    R3 = np.where(rowmark_v)[0]                          # vertical rows
    C2 = np.where(~colmark & ~colmark_v)[0]              # square part cols
    R2 = np.array(sorted(set(int(match[j]) for j in C2)), dtype=INDEX)

    # fine decomposition: SCC of the square part
    if len(C2):
        sub_col_of = np.full(n, -1, dtype=INDEX)
        sub_col_of[C2] = np.arange(len(C2), dtype=INDEX)
        sub_row_of = np.full(m, -1, dtype=INDEX)
        sub_row_of[R2] = np.arange(len(R2), dtype=INDEX)
        # adjacency among square columns through matched rows
        Bp = [0]
        Bi = []
        for j in C2:
            for p in range(A.indptr[j], A.indptr[j + 1]):
                i = int(A.indices[p])
                j2 = int(rmatch[i])
                if j2 != -1 and sub_col_of[j2] != -1:
                    Bi.append(int(sub_col_of[j2]))
            Bp.append(len(Bi))
        order, rb = strongcomp(np.array(Bp, dtype=INDEX),
                               np.array(Bi, dtype=INDEX), len(C2))
        C2o = C2[order]
        R2o = match[C2o]
    else:
        C2o = C2
        R2o = R2[:0]
        rb = np.zeros(1, dtype=INDEX)

    q = np.concatenate([C1, C2o, C3]).astype(INDEX)
    R_rest = np.setdiff1d(np.arange(m, dtype=INDEX),
                          np.concatenate([R1, R2o.astype(INDEX), R3]) if m else R1)
    p = np.concatenate([R1, R2o, R3, R_rest]).astype(INDEX)

    cc = np.array([0, len(C1), len(C1) + len(C2), n, n], dtype=INDEX)
    rr = np.array([0, len(R1), len(R1) + len(R2o), len(R1) + len(R2o) + len(R3), m],
                  dtype=INDEX)
    # fine blocks: horizontal part one block, square part per SCC, vertical one
    blocks = [0]
    if len(C1):
        blocks.append(len(C1))
    base = len(C1)
    for b in range(len(rb) - 1):
        blocks.append(base + int(rb[b + 1]))
    if len(C3):
        blocks.append(n)
    s = np.unique(np.array(blocks, dtype=INDEX))
    r = s.copy()  # square; for rectangular the row blocks mirror via rr
    return DMPermResult(p=p, q=q, r=r, s=s, cc=cc, rr=rr, structural_rank=nmatch)
