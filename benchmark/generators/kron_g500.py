"""The Graph500 Kronecker graph (Graph500 specification, the reference
generator kronecker_generator.m), as the GAP Benchmark Suite builds its
graph ``kron`` (Beamer, Asanovic, Patterson, arXiv:1508.03619): 2^scale
vertices and edgefactor * 2^scale edges, each edge's endpoints drawn one
bit a level from the initiator [[a, b], [c, d]] (d = 1 - a - b - c), the
vertex ids randomly permuted, then made undirected with self-loops and
duplicate edges removed.

Returns the strictly lower triangle of the undirected graph's adjacency
as SciPy CSC with float32 ones: each edge once, as an edge list gives it,
rows and columns as int32 while they fit.  The front end of the graph
cell (``solvers/graphblas.py``) reads it as a symmetric matrix stored by
its lower triangle.

It runs on the card when one is present (torch's Philox generator,
seeded with ``seed``), else on the CPU (the tests' sizes): the same seed
gives the same graph on the same kind of device.  The edges are made
``CHUNK`` at a time, and the graph a band of columns at a time
(``BANDS``): each band draws the whole edge stream again from the seed and
keeps the edges whose lower end falls in it, so that the card holds one
band's keys at once."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

CHUNK = 1 << 26
BANDS = 8


def _edges(scale: int, edgefactor: int, a: float, b: float, c: float,
           seed: int, dev):
    """The edge stream, a chunk at a time: (lower end, upper end) of each
    edge that is not a self-loop, int64, the ids permuted."""
    n = 1 << scale
    m = edgefactor * n
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=dev)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for s in range(0, m, CHUNK):
        k = min(CHUNK, m - s)
        u = torch.zeros(k, dtype=torch.int64, device=dev)
        v = torch.zeros(k, dtype=torch.int64, device=dev)
        for bit in range(scale):
            ii = torch.rand(k, generator=gen, device=dev) > ab
            jj = torch.rand(k, generator=gen, device=dev) > torch.where(
                ii, c_norm, a_norm)
            u |= ii.to(torch.int64) << bit
            v |= jj.to(torch.int64) << bit
        u, v = perm[u], perm[v]
        keep = u != v
        u, v = u[keep], v[keep]
        yield torch.minimum(u, v), torch.maximum(u, v)


def make(scale: int, edgefactor: int, a: float, b: float, c: float,
         seed: int) -> sp.csc_matrix:
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    n = 1 << scale
    # bands of equal edge share: the lower end of two ids uniform in
    # [0, n) is below x n with probability 1 - (1 - x)^2
    edges = [int(n * (1.0 - np.sqrt(1.0 - i / BANDS)))
             for i in range(BANDS)] + [n]
    counts = np.zeros(n, dtype=np.int64)
    rows = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        keys = []
        for j, i in _edges(scale, edgefactor, a, b, c, seed, dev):
            inside = (j >= lo) & (j < hi)
            keys.append(j[inside] * n + i[inside])
        key = torch.unique(torch.cat(keys))        # sorted: CSC order
        del keys
        col = key // n
        counts[lo:hi] = torch.bincount(col - lo,
                                       minlength=hi - lo).cpu().numpy()
        rows.append((key - col * n).to(torch.int32).cpu().numpy())
        del key, col
    nnz = int(counts.sum())
    idx = np.int32 if nnz < 2 ** 31 else np.int64
    indptr = np.zeros(n + 1, dtype=idx)
    np.cumsum(counts, out=indptr[1:])
    indices = np.concatenate(rows).astype(idx, copy=False)
    return sp.csc_matrix((np.ones(nnz, dtype=np.float32), indices, indptr),
                         shape=(n, n))
