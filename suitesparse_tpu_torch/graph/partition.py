"""Mongoose-equivalent graph partitioner: multilevel edge cut.

Reference behavior targeted (Mongoose, SURVEY.md §2 item 25): multilevel
coarsening via heavy-edge matching (Mongoose_Matching.cpp), initial guess
cuts, and "waterdance" refinement rounds (Mongoose_Waterdance.cpp)
alternating Fiduccia-Mattheyses boundary moves (Mongoose_ImproveFM.cpp)
with QP gradient projection on the continuous relaxation
(Mongoose_ImproveQP.cpp / Mongoose_QPGradProj.cpp): minimize the cut
f(x) = x'W(1-x) over the napsack polytope {x in [0,1]^n, lo <= w'x <= hi}
(projection solved by a monotone multiplier search,
Mongoose_QPNapsack.cpp), then round back to {0,1} under the balance
budget.  Random restarts on top.

Host-side analysis code (runs once per pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.sparse import INDEX, SparseCSC


@dataclasses.dataclass
class EdgeCutOptions:
    """Mongoose EdgeCut_Options analog (Mongoose.hpp:45-163)."""

    coarsen_limit: int = 64
    target_split: float = 0.5
    tolerance: float = 0.12          # allowed imbalance
    fm_passes: int = 4
    random_seed: int = 0
    restarts: int = 2
    use_fm: bool = True              # Mongoose use_FM
    use_qp: bool = True              # Mongoose use_QP_gradproj
    waterdance_rounds: int = 2       # FM<->QP alternations per level
    qp_iters: int = 12               # gradient-projection steps per call


@dataclasses.dataclass
class EdgeCutResult:
    partition: np.ndarray            # 0/1 per vertex
    cut_cost: float
    imbalance: float


def _to_adj(A: SparseCSC):
    """Symmetric adjacency (no diagonal) with edge weights."""
    import scipy.sparse as sp
    S = A.to_scipy()
    S = (abs(S) + abs(S).T)
    S.setdiag(0)
    S.eliminate_zeros()
    return S.tocsr()


def _heavy_edge_matching(G, rng):
    """Greedy heavy-edge matching; returns coarse map cmap (n -> nc)."""
    n = G.shape[0]
    order = rng.permutation(n)
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "sstpu_heavy_matching"):
        cmap = np.empty(n, dtype=np.int64)
        nc = lib.sstpu_heavy_matching(
            n, np.ascontiguousarray(G.indptr, dtype=np.int64),
            np.ascontiguousarray(G.indices, dtype=np.int64),
            np.ascontiguousarray(G.data, dtype=np.float64),
            np.ascontiguousarray(order, dtype=np.int64), cmap)
        return cmap.astype(INDEX, copy=False), int(nc)
    matched = np.full(n, -1, dtype=INDEX)
    for v in order:
        if matched[v] != -1:
            continue
        lo, hi = G.indptr[v], G.indptr[v + 1]
        best, bw = -1, 0.0
        for idx in range(lo, hi):
            u = G.indices[idx]
            if matched[u] == -1 and u != v and G.data[idx] > bw:
                best, bw = u, G.data[idx]
        if best >= 0:
            matched[v] = best
            matched[best] = v
        else:
            matched[v] = v
    cmap = np.full(n, -1, dtype=INDEX)
    nc = 0
    for v in range(n):
        if cmap[v] == -1:
            cmap[v] = nc
            if matched[v] != v:
                cmap[matched[v]] = nc
            nc += 1
    return cmap, nc


def _coarsen(G, vwt, cmap, nc):
    import scipy.sparse as sp
    n = G.shape[0]
    coo = G.tocoo()
    rows = cmap[coo.row]
    cols = cmap[coo.col]
    keep = rows != cols
    Gc = sp.coo_matrix((coo.data[keep], (rows[keep], cols[keep])),
                       shape=(nc, nc)).tocsr()
    Gc.sum_duplicates()
    vwtc = np.zeros(nc)
    np.add.at(vwtc, cmap, vwt)
    return Gc, vwtc


def _initial_cut(G, vwt, target, rng):
    """BFS region growing from a random seed to the target weight."""
    n = G.shape[0]
    total = vwt.sum()
    part = np.ones(n, dtype=np.int8)
    seed = int(rng.integers(n))
    w = 0.0
    from collections import deque
    q = deque([seed])
    seen = np.zeros(n, dtype=bool)
    seen[seed] = True
    order = []
    while q and w < target * total:
        v = q.popleft()
        part[v] = 0
        w += vwt[v]
        order.append(v)
        for u in G.indices[G.indptr[v]:G.indptr[v + 1]]:
            if not seen[u]:
                seen[u] = True
                q.append(u)
    # disconnected leftovers
    if w < target * total:
        for v in range(n):
            if part[v] == 1 and w < target * total:
                part[v] = 0
                w += vwt[v]
    return part


def _cut_of(G, part):
    """Vectorized cut weight."""
    coo = G.tocoo()
    m = part[coo.row] != part[coo.col]
    return float(coo.data[m].sum()) / 2.0


def _fm_refine(G, vwt, part, tolerance, target, passes, rng):
    """Fiduccia-Mattheyses boundary refinement: classic single-move passes
    with a lazy max-heap of gains, balance constraint, best-prefix rollback
    (Mongoose_ImproveFM equivalent)."""
    import heapq

    n = G.shape[0]
    total = vwt.sum()
    lo_w = (target - tolerance) * total
    hi_w = (target + tolerance) * total
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "sstpu_fm_refine"):
        p8 = np.ascontiguousarray(part, dtype=np.int8)
        cut = lib.sstpu_fm_refine(
            n, np.ascontiguousarray(G.indptr, dtype=np.int64),
            np.ascontiguousarray(G.indices, dtype=np.int64),
            np.ascontiguousarray(G.data, dtype=np.float64),
            np.ascontiguousarray(vwt, dtype=np.float64), p8,
            float(lo_w), float(hi_w), int(passes))
        return p8.astype(part.dtype, copy=False), float(cut)
    indptr, indices, data = G.indptr, G.indices, G.data

    best_part = part.copy()
    best_cut = _cut_of(G, part)
    w0 = float(vwt[part == 0].sum())
    rowid = np.repeat(np.arange(n), np.diff(indptr))
    for _ in range(passes):
        # vectorized gains: ext - int per vertex
        same = part[indices] == part[rowid]
        contrib = np.where(same, -data, data)
        gains = np.zeros(n)
        np.add.at(gains, rowid, contrib)
        stamp = np.zeros(n, dtype=np.int64)   # lazy-heap version counter
        # seed the heap with BOUNDARY vertices only (any external edge) —
        # interior vertices can never be the best first move and enter
        # lazily when a neighbor flips (Mongoose boundary-heap behavior)
        bnd = np.zeros(n, dtype=bool)
        np.logical_or.at(bnd, rowid, ~same)
        heap = [(-gains[v], 0, v) for v in np.nonzero(bnd)[0]]
        heapq.heapify(heap)
        locked = np.zeros(n, dtype=bool)
        cur_cut = best_cut
        pass_best_cut = best_cut
        pass_best_state = None
        moves_since_best = 0
        improved = False
        while heap and moves_since_best < max(64, n // 32):
            negg, ver, v = heapq.heappop(heap)
            if locked[v] or ver != stamp[v]:
                continue
            neww0 = w0 - vwt[v] if part[v] == 0 else w0 + vwt[v]
            if not (lo_w <= neww0 <= hi_w):
                continue
            cur_cut -= gains[v]
            part[v] = 1 - part[v]
            w0 = neww0
            locked[v] = True
            lo, hi = int(indptr[v]), int(indptr[v + 1])
            for idx in range(lo, hi):
                u = int(indices[idx])
                if locked[u]:
                    continue
                # part[v] already flipped: neighbor now on v's side had an
                # external edge become internal (gain -2w); other side +2w
                delta = 2.0 * data[idx]
                gains[u] += -delta if part[u] == part[v] else delta
                stamp[u] += 1
                heapq.heappush(heap, (-gains[u], stamp[u], u))
            if cur_cut < pass_best_cut - 1e-12:
                pass_best_cut = cur_cut
                pass_best_state = part.copy()
                moves_since_best = 0
                improved = True
            else:
                moves_since_best += 1
        if pass_best_state is not None:
            part = pass_best_state
            best_part = part.copy()
            best_cut = pass_best_cut
        else:
            part = best_part.copy()
        w0 = float(vwt[part == 0].sum())
        if not improved:
            break
    return best_part, best_cut


def _napsack_project(y, a, lo, hi):
    """Project y onto {x in [0,1]^n : lo <= a'x <= hi} (a > 0) — the
    separable QP of Mongoose_QPNapsack.cpp.  x(lam) = clip(y - lam*a, 0, 1)
    has monotone budget a'x(lam); solve for the multiplier by bisection."""
    x = np.clip(y, 0.0, 1.0)
    s = a @ x
    if lo <= s <= hi:
        return x
    tgt = hi if s > hi else lo
    # bracket the multiplier
    scale = max(1.0, np.abs(y).max() / max(a.min(), 1e-12))
    lam_lo, lam_hi = -scale - 1.0, scale + 1.0
    for _ in range(30):
        lam = 0.5 * (lam_lo + lam_hi)
        s = a @ np.clip(y - lam * a, 0.0, 1.0)
        if s > tgt:
            lam_lo = lam
        else:
            lam_hi = lam
    return np.clip(y - 0.5 * (lam_lo + lam_hi) * a, 0.0, 1.0)


def _qp_gradproj(G, vwt, part, tolerance, target, iters):
    """QP gradient projection on the continuous cut relaxation
    (Mongoose_QPGradProj.cpp): f(x) = x'W(1-x), gradient W(1-2x), projected
    steps over the napsack polytope, then balanced rounding."""
    total = vwt.sum()
    lo_w = (target - tolerance) * total
    hi_w = (target + tolerance) * total
    x = part.astype(np.float64)
    # step size ~ 1/||W||_inf keeps the projected iteration stable
    row_sums = np.asarray(np.abs(G).sum(axis=1)).ravel()
    alpha = 1.0 / max(row_sums.max(), 1e-12)
    fbest = np.inf
    xbest = x
    G1 = np.asarray(G @ np.ones(G.shape[0]))
    stall = 0
    for _ in range(iters):
        Gx = G @ x                       # one matvec per iteration:
        g = G1 - 2.0 * Gx                # grad = G(1-2x), f = x'G(1-x)
        f = float(x @ G1 - x @ Gx)
        if f < fbest - 1e-12:
            fbest, xbest, stall = f, x.copy(), 0
        else:
            stall += 1
            if stall >= 3:
                break
        x = _napsack_project(x - alpha * g, vwt, lo_w, hi_w)
    Gx = G @ x
    f = float(x @ G1 - x @ Gx)
    if f < fbest - 1e-12:
        fbest, xbest = f, x
    # balanced rounding: side 1 takes the largest-x prefix whose weight
    # lands inside the budget (closest to target)
    order = np.argsort(-xbest, kind="stable")
    csum = np.cumsum(vwt[order])
    w1_target = (1.0 - target) * total
    k = int(np.argmin(np.abs(csum - w1_target))) + 1
    out = np.zeros(len(xbest), dtype=np.int8)
    out[order[:k]] = 1
    return out


def _waterdance(G, vwt, part, opt, rng):
    """Alternate FM and QP improvement until neither helps
    (Mongoose_Waterdance.cpp)."""
    best = part
    best_cut = _cut_of(G, part)
    for _ in range(max(1, opt.waterdance_rounds)):
        improved = False
        if opt.use_fm:
            cand, cut = _fm_refine(G, vwt, best.copy(), opt.tolerance,
                                   opt.target_split, opt.fm_passes, rng)
            if cut < best_cut - 1e-12:
                best, best_cut, improved = cand, cut, True
        if opt.use_qp:
            cand = _qp_gradproj(G, vwt, best.copy(), opt.tolerance,
                                opt.target_split, opt.qp_iters)
            cut = _cut_of(G, cand)
            if cut < best_cut - 1e-12:
                best, best_cut, improved = cand, cut, True
        if not improved:
            break
    return best, best_cut


def edge_cut(A: SparseCSC, options: Optional[EdgeCutOptions] = None) -> EdgeCutResult:
    """Mongoose edge_cut: bisect the graph of A minimizing edge cut subject
    to balance (Mongoose.hpp:162)."""
    return _edge_cut_adj(_to_adj(A), options)


def _edge_cut_adj(G0, options: Optional[EdgeCutOptions] = None
                  ) -> EdgeCutResult:
    """edge_cut on a prebuilt CSR adjacency (shared with vertex_separator
    so the adjacency is built once per bisection)."""
    opt = options or EdgeCutOptions()
    rng = np.random.default_rng(opt.random_seed)
    n = G0.shape[0]
    if n <= 2:
        part = np.zeros(n, dtype=np.int8)
        if n == 2:
            part[1] = 1
        return EdgeCutResult(part, 0.0, 0.0)

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "sstpu_edge_cut"):
        # full native V-cycle (coarsen + FM + QP waterdance + restarts):
        # the per-level Python/scipy round-trips dominated nesdis analyze
        # time (round-4 profile: ~6 of 10 s at n=85k)
        part = np.empty(n, dtype=np.int8)
        cut = lib.sstpu_edge_cut(
            n, np.ascontiguousarray(G0.indptr, dtype=np.int64),
            np.ascontiguousarray(G0.indices, dtype=np.int64),
            np.ascontiguousarray(G0.data, dtype=np.float64),
            float(opt.target_split), float(opt.tolerance),
            int(opt.coarsen_limit), int(opt.restarts),
            int(opt.fm_passes), int(opt.waterdance_rounds),
            int(opt.qp_iters), int(opt.random_seed) + 1, part)
        w0 = float((part == 0).sum()) / n
        return EdgeCutResult(part, float(cut),
                             abs(w0 - opt.target_split))

    best = None
    for restart in range(opt.restarts):
        # multilevel V-cycle
        graphs = [(G0, np.ones(n))]
        maps = []
        while graphs[-1][0].shape[0] > opt.coarsen_limit:
            G, vwt = graphs[-1]
            cmap, nc = _heavy_edge_matching(G, rng)
            if nc >= G.shape[0] * 0.95:   # coarsening stalled
                break
            graphs.append(_coarsen(G, vwt, cmap, nc))
            maps.append(cmap)
        # initial cut at the coarsest level
        Gc, vwtc = graphs[-1]
        part = _initial_cut(Gc, vwtc, opt.target_split, rng)
        part, _ = _waterdance(Gc, vwtc, part, opt, rng)
        # uncoarsen + refine
        for lvl in range(len(maps) - 1, -1, -1):
            part = part[maps[lvl]]
            G, vwt = graphs[lvl]
            part, _ = _waterdance(G, vwt, part, opt, rng)
        # score
        cut = 0.0
        coo = G0.tocoo()
        m = part[coo.row] != part[coo.col]
        cut = float(coo.data[m].sum()) / 2.0
        w0 = float((part == 0).sum()) / n
        imb = abs(w0 - opt.target_split)
        if best is None or cut < best.cut_cost:
            best = EdgeCutResult(part.copy(), cut, imb)
    return best


def _min_vertex_cover(b0, b1, edges):
    """Minimum vertex cover of the bipartite cut-edge graph by König's
    theorem: maximum matching (augmenting-path search), then cover =
    (B0 \\ Z) u (B1 n Z) where Z = vertices reachable from unmatched B0
    vertices along alternating paths.  This is the optimal edge-cut ->
    vertex-separator conversion (smallest separator realizing the cut)."""
    id0 = {v: i for i, v in enumerate(b0)}
    id1 = {v: i for i, v in enumerate(b1)}
    adj = [[] for _ in b0]                 # B0-local -> list of B1-local
    for v, u in edges:
        adj[id0[v]].append(id1[u])
    match0 = np.full(len(b0), -1, dtype=INDEX)
    match1 = np.full(len(b1), -1, dtype=INDEX)

    def augment(i, seen):
        for j in adj[i]:
            if seen[j]:
                continue
            seen[j] = True
            if match1[j] == -1 or augment(match1[j], seen):
                match0[i] = j
                match1[j] = i
                return True
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 2 * (len(b0) + len(b1)) + 100))
    try:
        for i in range(len(b0)):
            augment(i, np.zeros(len(b1), dtype=bool))
    finally:
        sys.setrecursionlimit(old)

    # alternating BFS from unmatched B0 vertices
    z0 = np.zeros(len(b0), dtype=bool)
    z1 = np.zeros(len(b1), dtype=bool)
    from collections import deque
    q = deque(i for i in range(len(b0)) if match0[i] == -1)
    for i in q:
        z0[i] = True
    while q:
        i = q.popleft()
        for j in adj[i]:
            if z1[j]:
                continue
            z1[j] = True
            i2 = match1[j]
            if i2 != -1 and not z0[i2]:
                z0[i2] = True
                q.append(i2)
    cover = [b0[i] for i in range(len(b0)) if not z0[i]]
    cover += [b1[j] for j in range(len(b1)) if z1[j]]
    return cover


def vertex_separator(A: SparseCSC, options: Optional[EdgeCutOptions] = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert an edge cut into a vertex separator (cholmod_bisect analog):
    returns (left, right, sep) index arrays.

    Separator = minimum vertex cover of the cut edges (König), i.e. the
    smallest vertex set whose removal disconnects the two sides of the
    computed edge cut.
    """
    return _vertex_separator_adj(_to_adj(A), options)


def _vertex_separator_adj(G, options: Optional[EdgeCutOptions] = None
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """vertex_separator on a prebuilt CSR adjacency (shared with the
    nesdis recursion, which slices one top-level adjacency instead of
    rebuilding scipy matrices per subgraph)."""
    res = _edge_cut_adj(G, options)
    part = res.partition
    n = G.shape[0]
    # cut edges, vectorized over the CSR (each undirected edge appears once
    # in the 0->1 direction)
    rowid = np.repeat(np.arange(n, dtype=INDEX), np.diff(G.indptr))
    m = (part[rowid] == 0) & (part[G.indices] == 1)
    e0g, e1g = rowid[m], G.indices[m].astype(INDEX)
    if len(e0g) == 0:
        sep = np.empty(0, dtype=INDEX)
    else:
        b0 = np.unique(e0g)
        b1 = np.unique(e1g)
        from ..utils.native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "sstpu_vertex_cover"):
            c0 = np.empty(len(b0), dtype=np.uint8)
            c1 = np.empty(len(b1), dtype=np.uint8)
            lib.sstpu_vertex_cover(
                len(b0), len(b1), len(e0g),
                np.ascontiguousarray(np.searchsorted(b0, e0g),
                                     dtype=np.int64),
                np.ascontiguousarray(np.searchsorted(b1, e1g),
                                     dtype=np.int64), c0, c1)
            sep = np.sort(np.concatenate([b0[c0 == 1], b1[c1 == 1]]))
        else:
            edges = list(zip(e0g.tolist(), e1g.tolist()))
            cover = _min_vertex_cover(b0.tolist(), b1.tolist(), edges)
            sep = np.array(sorted(cover), dtype=INDEX)
    mask = np.zeros(n, dtype=bool)
    mask[sep] = True
    left = np.nonzero((part == 0) & ~mask)[0].astype(INDEX)
    right = np.nonzero((part == 1) & ~mask)[0].astype(INDEX)
    return left, right, sep.astype(INDEX)
