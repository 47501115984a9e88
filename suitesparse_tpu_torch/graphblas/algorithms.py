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
the reference's iteration with the same state.

PageRank reads only the graph's pattern (each arc i -> j weighs
1 / outdeg(i), whatever value it stores), which ``compact_graph`` puts on
the device once per graph: int32 source ids in CSC order, the columns'
offsets, and the inverse out-degree per vertex, about 4 bytes an arc.  A
power step gathers the per-vertex contribution r / outdeg through the
source ids and sums it over each destination's sorted segment: the same
products, in the same order, as the reference's per-arc weights, so the
ranks are the per-arc form's bit for bit.  A symmetric matrix stored by
one triangle (``stype`` != 0) is an undirected graph: the import expands
it on the device.

Spans and counters (``utils/trace``): ``graphblas.pagerank`` over a call,
inside it ``.import`` (the device arrays made, a graph's first call; its
h2d bytes), ``.program`` (each loop-program run), ``.sync`` (the flag's
read) and ``.download`` (the ranks to the host); the counters
``graphblas.pagerank.iterations``, ``.steps_run`` (predicated steps run,
those after the stop included) and ``.program_runs``."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.sparse import SparseCSC
from ..utils.device import default_dtype, resolve_device, torch_dtype
from ..utils.programs import cached_program
from ..utils.trace import count, moved, span
from .core import GrBMatrix, segment_reduce

# predicated iterations a loop program runs between two reads of its
# flag: 8 and 16 were the fastest of 1, 4, 8 and 16 for PageRank and BFS
# at n = 1e6 on the card, within 1% of each other (chip_smoke.py [graph],
# PERF.md); 8 runs at most 7 steps past the stop, where a step costs the
# device 1.2 ms
LOOP_STEPS = 8
# entries a chunk of the import's device work: bounds its temporaries
IMPORT_CHUNK = 1 << 25
PR = "graphblas.pagerank"


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


@dataclasses.dataclass(eq=False)
class CompactGraph:
    """A graph's pattern on one device as PageRank's power step reads it:
    ``rows`` (int32) the source of each arc, sorted by destination (CSC
    order), ``offsets`` (int64, n + 1) where each destination's arcs
    start, ``dinv`` 1 / max(outdeg, 1) per vertex in the ranks' dtype."""

    rows: torch.Tensor
    offsets: torch.Tensor
    dinv: torch.Tensor
    n: int

    @property
    def arcs(self) -> int:
        return self.rows.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self.dinv.dtype


def _chunks(total: int):
    for a in range(0, total, IMPORT_CHUNK):
        yield a, min(a + IMPORT_CHUNK, total)


def _upload_rows(indices: np.ndarray, dev) -> torch.Tensor:
    """The host row ids as int32 on ``dev``, cast there a chunk at a
    time (no int32 copy on the host, no int64 array on the device)."""
    out = torch.empty(len(indices), dtype=torch.int32, device=dev)
    for a, b in _chunks(len(indices)):
        part = torch.from_numpy(indices[a:b]).to(dev)
        moved("h2d", part.numel() * part.element_size())
        out[a:b].copy_(part)
    return out


def _symmetrize(stored, indptr, n: int, lower: bool) -> tuple:
    """(rows, offsets) of the full pattern of a symmetric matrix stored by
    its lower (``lower``) or upper triangle in CSC order: each stored
    entry (i, j), i != j, stands for (j, i) too.  Column j of the result
    holds the mirrored entries (the stored row j) before its stored ones
    where the lower triangle is stored, after them where the upper is, so
    every column stays sorted."""
    dev = stored.device
    lens = torch.diff(indptr)

    def part(a, b):
        """Rows, columns and the off-diagonal mask of entries [a, b)."""
        r = stored[a:b].long()
        c = torch.searchsorted(indptr, torch.arange(a, b, device=dev),
                               right=True) - 1
        return r, c, r != c

    mirror = torch.zeros(n, dtype=torch.int64, device=dev)
    for a, b in _chunks(stored.numel()):
        r, _, off = part(a, b)
        mirror += torch.bincount(r[off], minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens + mirror, 0, out=offsets[1:])
    rows = torch.empty(int(offsets[-1]), dtype=torch.int32, device=dev)
    first = offsets[:-1] + (mirror if lower else 0)
    fill = offsets[:-1] + (0 if lower else lens)
    for a, b in _chunks(stored.numel()):
        r, c, off = part(a, b)
        rows[first[c] + torch.arange(a, b, device=dev) - indptr[c]] = \
            stored[a:b]
        # the mirrored entries of each row, in the order of their columns:
        # a stable sort by row within the chunk, after the earlier chunks'
        key, order = torch.sort(r[off], stable=True)
        rank = (torch.arange(key.numel(), device=dev)
                - torch.searchsorted(key, key))
        rows[fill[key] + rank] = c[off][order].to(torch.int32)
        fill += torch.bincount(key, minlength=n)
    return rows, offsets


def compact_graph(A, device=None) -> CompactGraph:
    """The device layout of the graph ``A`` (a square SparseCSC or a
    GrBMatrix; A[i, j] != 0 means an arc i -> j; a SparseCSC with
    ``stype`` != 0 is symmetric, stored by one triangle) on ``device``
    (None: the card), for ranks in its default float type, made once (the
    span ``graphblas.pagerank.import``) and cached on ``A``.  Only the
    pattern is read: no value reaches the device."""
    dev = resolve_device(device)
    cache = _pattern_cache(A)
    key = ("pagerank_graph", dev)
    got = cache.get(key)
    if got is None:
        with span(PR + ".import"):
            got = cache[key] = _import(
                A.to_csc() if isinstance(A, GrBMatrix) else A, dev,
                torch_dtype(default_dtype(dev)))
    return got


def _import(A: SparseCSC, dev, fdt) -> CompactGraph:
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(f"pagerank: the graph's matrix is {A.shape}, not "
                         f"square")
    indptr = torch.tensor(A.indptr, dtype=torch.int64, device=dev)
    moved("h2d", indptr.numel() * 8)
    rows = _upload_rows(A.indices, dev)
    if A.stype:
        rows, offsets = _symmetrize(rows, indptr, n, A.stype < 0)
    else:
        offsets = indptr
    outdeg = torch.zeros(n, dtype=torch.int64, device=dev)
    for a, b in _chunks(rows.numel()):
        outdeg += torch.bincount(rows[a:b], minlength=n)
    dinv = 1.0 / torch.clamp(outdeg.to(fdt), min=1.0)
    return CompactGraph(rows, offsets, dinv, n)


def _pagerank_update(y, r, n, damping):
    """Damping and the dangling mass, from y = W' r."""
    rnew = damping * y + (1.0 - damping) / n
    return rnew + (torch.sum(r) - torch.sum(rnew)) / n


def _pagerank_step(rows, cols, wvals, lengths, n, damping, r):
    """One power step on per-arc weights: y = W' r over plus_times (terms
    sorted by destination column), damping and the dangling mass."""
    y = segment_reduce("plus", wvals * r[rows], cols, n,
                       indices_are_sorted=True, lengths=lengths)
    return _pagerank_update(y, r, n, damping)


def _compact_step(g: CompactGraph, damping, r):
    """One power step on the compact layout: r / outdeg gathered through
    the source ids, summed per destination."""
    y = torch.segment_reduce(torch.index_select(r * g.dinv, 0, g.rows),
                             "sum", offsets=g.offsets, axis=0, unsafe=True)
    return _pagerank_update(y, r, g.n, damping)


def _loop(make_step, n, dtype, dev, damping, tol, max_iter, steps, cache):
    """The reference's while_loop over the power step ``make_step()``
    makes: returns (rank, iterations run).  Each program run takes
    ``steps`` predicated steps; ``cache`` (the pattern's, or a new one)
    keeps the program per (steps, damping, tol, dtype, device)."""
    cache = {} if cache is None else cache

    def make():
        step = make_step()

        def body(r, st, max_it):
            # st = (iterations run, does the next step run); the reference
            # starts with delta = inf, so the flag starts as it < max_iter
            it, go = st[0], st[1].bool()
            for _ in range(steps):
                rnew = step(r)
                # compared in the working dtype, as the reference's
                # condition
                above_tol = (rnew - r).abs().sum() > tol
                r = torch.where(go, rnew, r)
                it = it + go
                go = go & above_tol & (it < max_it)
            return r, torch.stack((it, go.to(it.dtype)))
        return body

    prog = cached_program(cache, ("pagerank", int(steps), float(damping),
                                  float(tol), dtype, dev), make, dev)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    # made on the card: an element set from a host value would be a
    # copy that waits for the host
    st = torch.full((2,), int(max_iter > 0), dtype=torch.int64, device=dev)
    st[0].zero_()
    max_it = torch.full((), int(max_iter), dtype=torch.int64, device=dev)
    it = 0
    go = max_iter > 0
    while go:
        with span(PR + ".program"):
            r, st = prog(r, st, max_it)
        with span(PR + ".sync"):
            it, go = st.tolist()      # the one host sync of a run
        count(PR + ".program_runs")
        count(PR + ".steps_run", steps)
    count(PR + ".iterations", it)
    return r, it


def _pagerank_loop(rows, cols, wvals, n, damping, tol, max_iter,
                   steps=LOOP_STEPS, cache=None):
    """The loop on per-arc weights ``wvals`` (arcs ``rows`` -> ``cols``,
    sorted by column): returns (rank, iterations run)."""
    def make_step():
        lengths = torch.bincount(cols, minlength=n)
        return functools.partial(_pagerank_step, rows, cols, wvals,
                                 lengths, n, damping)
    return _loop(make_step, n, wvals.dtype, wvals.device, damping, tol,
                 max_iter, steps, cache)


def pagerank(A, damping: float = 0.85, tol: float = 1e-9,
             max_iter: int = 100, device=None) -> np.ndarray:
    """PageRank (dpagerank.c demo analog).  A[i,j] != 0 means an edge
    i -> j (a SparseCSC with ``stype`` != 0: the symmetric graph of the
    stored triangle).  Runs on ``device`` (None: the card) in its default
    float type (float64 on the CPU, float32 on the card), from uniform
    ranks until the L1 change of a step is at most ``tol`` or ``max_iter``
    steps ran; the counter ``graphblas.pagerank.iterations``
    (``utils.trace.counts``) adds the steps it ran."""
    with span(PR):
        r, _ = _pagerank(A, damping, tol, max_iter, resolve_device(device))
        with span(PR + ".download"):
            out = r.cpu().numpy()
            moved("d2h", out.nbytes)
    return out


def _pagerank(A, damping, tol, max_iter, dev, steps=LOOP_STEPS):
    """pagerank's loop on the pattern's compact layout and cached program:
    (rank tensor, iterations)."""
    g = compact_graph(A, dev)
    return _loop(lambda: functools.partial(_compact_step, g, float(damping)),
                 g.n, g.dtype, dev, float(damping), float(tol),
                 int(max_iter), steps, _pattern_cache(A))


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
