"""Graph algorithms on the GraphBLAS-lite layer (the reference's demo
algebra: GraphBLAS/Demo — pagerank, BFS, triangle counting).

Counterpart of suitesparse_tpu/graphblas/algorithms.py.  The reference
runs each iteration loop as one compiled ``lax.while_loop``; here it is a
Python loop over static-shape device tensors that tests the same condition
after every step, so it stops at the same iteration.  Testing it reads one
value back from the device per iteration (one host sync per step)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.sparse import SparseCSC
from ..utils.device import default_dtype, resolve_device, torch_dtype
from .core import GrBMatrix, segment_reduce


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


def _pagerank_loop(rows, cols, wvals, n, damping, tol, max_iter):
    """The reference's while_loop: returns (rank, iterations run)."""
    # y = W' r over plus_times: terms sorted by destination column
    lengths = torch.bincount(cols, minlength=n)
    r = torch.full((n,), 1.0 / n, dtype=wvals.dtype, device=wvals.device)
    it = 0
    above_tol = True                 # the reference starts with delta = inf
    while above_tol and it < max_iter:
        y = segment_reduce("plus", wvals * r[rows], cols, n,
                           indices_are_sorted=True, lengths=lengths)
        rnew = damping * y + (1.0 - damping) / n
        rnew = rnew + (torch.sum(r) - torch.sum(rnew)) / n   # dangling mass
        # compared in the working dtype, as the reference's condition
        above_tol = bool((rnew - r).abs().sum() > tol)
        r = rnew
        it += 1
    return r, it


def pagerank(A, damping: float = 0.85, tol: float = 1e-9,
             max_iter: int = 100, device=None) -> np.ndarray:
    """PageRank (dpagerank.c demo analog).  A[i,j] != 0 means an edge
    i -> j.  Runs on ``device`` (None: the card) in its default float type
    (float64 on the CPU, float32 on the card)."""
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    dev = resolve_device(device)
    n = Ac.shape[0]
    rows, cols, _ = _coo_arrays(Ac, dev)
    fdt = torch_dtype(default_dtype(dev))
    outdeg = torch.clamp(torch.bincount(rows, minlength=n).to(fdt), min=1.0)
    wvals = (1.0 / outdeg[rows]).to(fdt)
    r, _ = _pagerank_loop(rows, cols, wvals, n, float(damping), float(tol),
                          int(max_iter))
    return r.cpu().numpy()


def _bfs_loop(rows, cols, n, source):
    """The reference's pull-step while_loop: returns (levels, steps)."""
    dev = rows.device
    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True
    depth = 1
    while bool(frontier.any()) and depth <= n:
        hit = segment_reduce("max", frontier[rows].to(torch.int32), cols, n,
                             indices_are_sorted=True) > 0
        nxt = hit & (level < 0)
        level = torch.where(nxt, torch.tensor(depth, dtype=torch.int32,
                                              device=dev), level)
        frontier = nxt
        depth += 1
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
        rows, cols, _ = _coo_arrays(Ac, resolve_device(device))
        level, _ = _bfs_loop(rows, cols, n, source)
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
