"""Graph algorithms on the GraphBLAS-lite layer (the reference's demo
algebra: GraphBLAS/Demo — pagerank, BFS, triangle counting).

Counterpart of suitesparse_tpu/graphblas/algorithms.py.  The reference
runs each iteration loop as one compiled ``lax.while_loop``.  Here a loop
is a device program of ``steps`` predicated iterations (utils/programs.py:
a CUDA graph replayed on the card), cached with the graph's pattern: a
step whose condition already failed leaves the state as it was (a
``torch.where`` on a device flag, which also advances the iteration
counter), and the host reads the flag and the counter once per program
run.  So a loop of m iterations syncs ceil(m / steps) times, and stops at
the reference's iteration with the same state."""
from __future__ import annotations

import numpy as np
import torch

from ..core.sparse import SparseCSC
from ..utils.device import default_dtype, resolve_device, torch_dtype
from ..utils.programs import cached_program
from .core import GrBMatrix, segment_reduce

# predicated iterations a loop program runs between two reads of its
# flag: 8 and 16 were the fastest of 1, 4, 8 and 16 for PageRank and BFS
# at n = 1e6 on the card, within 1% of each other (chip_smoke.py [graph],
# PERF.md); 8 runs at most 7 steps past the stop, where a step costs the
# device 1.2 ms
LOOP_STEPS = 8


def _coo_arrays(A: SparseCSC, dev):
    """(rows, cols, vals) in CSC data order — already sorted by column,
    which makes column-destination segment reductions sorted."""
    rows = torch.as_tensor(np.asarray(A.indices, dtype=np.int64), device=dev)
    cols = torch.as_tensor(
        np.repeat(np.arange(A.shape[1], dtype=np.int64),
                  np.diff(A.indptr)), device=dev)
    vals = torch.as_tensor(A.data if A.data is not None else np.ones(A.nnz),
                           device=dev)
    return rows, cols, vals


def _pattern_cache(A) -> dict:
    """The programs and device arrays of the graph ``A`` (a SparseCSC or a
    GrBMatrix), kept on the object so that they are freed with it."""
    cache = getattr(A, "_loop_programs", None)
    if cache is None:
        cache = A._loop_programs = {}
    return cache


def _pagerank_step(rows, cols, wvals, lengths, n, damping, r):
    """One power step: y = W' r over plus_times (terms sorted by
    destination column), damping and the dangling mass."""
    y = segment_reduce("plus", wvals * r[rows], cols, n,
                       indices_are_sorted=True, lengths=lengths)
    rnew = damping * y + (1.0 - damping) / n
    return rnew + (torch.sum(r) - torch.sum(rnew)) / n


def _pagerank_loop(rows, cols, wvals, n, damping, tol, max_iter,
                   steps=LOOP_STEPS, cache=None):
    """The reference's while_loop: returns (rank, iterations run).  Each
    program run takes ``steps`` predicated steps; ``cache`` (the pattern's,
    or a new one) keeps the program per (steps, damping, tol, dtype,
    device)."""
    dev = wvals.device
    cache = {} if cache is None else cache

    def make():
        lengths = torch.bincount(cols, minlength=n)

        def body(r, st, max_it):
            # st = (iterations run, does the next step run); the reference
            # starts with delta = inf, so the flag starts as it < max_iter
            it, go = st[0], st[1].bool()
            for _ in range(steps):
                rnew = _pagerank_step(rows, cols, wvals, lengths, n,
                                      damping, r)
                # compared in the working dtype, as the reference's
                # condition
                above_tol = (rnew - r).abs().sum() > tol
                r = torch.where(go, rnew, r)
                it = it + go
                go = go & above_tol & (it < max_it)
            return r, torch.stack((it, go.to(it.dtype)))
        return body

    prog = cached_program(cache, ("pagerank", int(steps), float(damping),
                                  float(tol), wvals.dtype, dev), make, dev)
    r = torch.full((n,), 1.0 / n, dtype=wvals.dtype, device=dev)
    # made on the card: an element set from a host value would be a
    # copy that waits for the host
    st = torch.full((2,), int(max_iter > 0), dtype=torch.int64, device=dev)
    st[0].zero_()
    max_it = torch.full((), int(max_iter), dtype=torch.int64, device=dev)
    it = 0
    go = max_iter > 0
    while go:
        r, st = prog(r, st, max_it)
        it, go = st.tolist()          # the one host sync of a run
    return r, it


def pagerank(A, damping: float = 0.85, tol: float = 1e-9,
             max_iter: int = 100, device=None) -> np.ndarray:
    """PageRank (dpagerank.c demo analog).  A[i,j] != 0 means an edge
    i -> j.  Runs on ``device`` (None: the card) in its default float type
    (float64 on the CPU, float32 on the card)."""
    r, _ = _pagerank(A, damping, tol, max_iter, resolve_device(device))
    return r.cpu().numpy()


def _pagerank(A, damping, tol, max_iter, dev, steps=LOOP_STEPS):
    """pagerank's loop on the pattern's cached arrays and program:
    (rank tensor, iterations)."""
    cache = _pattern_cache(A)
    fdt = torch_dtype(default_dtype(dev))
    got = cache.get(("pagerank_arrays", fdt, dev))
    if got is None:
        Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
        n = Ac.shape[0]
        rows, cols, _ = _coo_arrays(Ac, dev)
        outdeg = torch.clamp(torch.bincount(rows, minlength=n).to(fdt),
                             min=1.0)
        got = cache[("pagerank_arrays", fdt, dev)] = (
            rows, cols, (1.0 / outdeg[rows]).to(fdt), n)
    rows, cols, wvals, n = got
    return _pagerank_loop(rows, cols, wvals, n, float(damping), float(tol),
                          int(max_iter), steps, cache)


def _bfs_loop(rows, cols, n, source, steps=LOOP_STEPS, cache=None):
    """The reference's pull-step while_loop: returns (levels, steps run).
    Each program run takes ``steps`` predicated steps; ``cache`` as in
    ``_pagerank_loop``."""
    dev = rows.device
    cache = {} if cache is None else cache

    def make():
        def body(level, frontier, st):
            # st = (depth, does the next step run)
            depth, go = st[0], st[1].bool()
            for _ in range(steps):
                hit = segment_reduce("max", frontier[rows].to(torch.int32),
                                     cols, n, indices_are_sorted=True) > 0
                nxt = hit & (level < 0)
                level = torch.where(go & nxt, depth.to(torch.int32), level)
                frontier = torch.where(go, nxt, frontier)
                depth = depth + go
                go = go & frontier.any() & (depth <= n)
            return level, frontier, torch.stack((depth, go.to(depth.dtype)))
        return body

    prog = cached_program(cache, ("bfs", int(steps), dev), make, dev)
    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level[source].fill_(0)        # fill_: no copy from the host
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source].fill_(True)
    st = torch.ones(2, dtype=torch.int64, device=dev)   # depth 1, go
    depth = 1
    go = n >= 1
    while go:
        level, frontier, st = prog(level, frontier, st)
        depth, go = st.tolist()       # the one host sync of a run
    return level, depth - 1


def bfs_levels(A, source: int, method: str = "device",
               device=None) -> np.ndarray:
    """BFS level per vertex (-1 unreachable), bfs5m.c demo analog.

    method="device": pull steps over a dense boolean frontier on
    ``device`` (None: the card), as the reference's device loop.
    method="push": host loop with a HYPERSPARSE frontier vector (the
    reference's push direction over sparse frontiers, GrB_Vector with
    GxB_HYPERSPARSE) — O(edges touched), best for huge low-degree graphs.
    """
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    n = Ac.shape[0]
    if method == "device":
        dev = resolve_device(device)
        cache = _pattern_cache(A)
        got = cache.get(("bfs_arrays", dev))
        if got is None:
            got = cache[("bfs_arrays", dev)] = _coo_arrays(Ac, dev)[:2]
        level, _ = _bfs_loop(*got, n, source, cache=cache)
        return level.cpu().numpy()  # int32
    # push over hypersparse frontier: walk CSR rows of the frontier only
    S = Ac.to_scipy().tocsr()
    level = np.full(n, -1, dtype=np.int32)
    level[source] = 0
    frontier_idx = np.array([source], dtype=np.int64)   # hypersparse vector
    depth = 0
    while len(frontier_idx):
        depth += 1
        # neighbors of the frontier = union of its CSR rows
        starts, ends = S.indptr[frontier_idx], S.indptr[frontier_idx + 1]
        total = int((ends - starts).sum())
        if total == 0:
            break
        nbr = np.empty(total, dtype=np.int64)
        k = 0
        for s, e in zip(starts, ends):
            nbr[k:k + (e - s)] = S.indices[s:e]
            k += e - s
        nbr = np.unique(nbr)
        nxt = nbr[level[nbr] < 0]
        level[nxt] = depth
        frontier_idx = nxt
    return level


def triangle_count(A, device=None) -> int:
    """Number of triangles: C<L> = L·Lᵀ over plus_pair, then reduce — the
    reference's masked dot3 tricount.  The mask restricts the Gustavson
    expansion at plan time, so only wedge closures that land on an edge
    are computed; the product runs on ``device`` (None: the card)."""
    from ..ops.spgemm import cached_plan, spgemm_apply
    from .core import select
    Ac = A if isinstance(A, SparseCSC) else A.to_csc()
    L = select(Ac, lambda r, c, v: r > c)      # strictly lower pattern
    ones = np.ones(L.nnz)
    plan = cached_plan(L, L.transpose(), mask=L)
    if plan.nnz == 0:
        return 0
    vals = spgemm_apply(plan, ones, ones, "plus_pair", device=device)
    return int(round(float(torch.sum(vals))))
