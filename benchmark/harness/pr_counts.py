"""The work of PageRank's power iterations on a graph of n vertices and
``arcs`` arcs, whatever layout or kernels carry it: each iteration reads
4 bytes an arc (its source id, the least that names a vertex below 2^31)
and each per-vertex vector once (the ranks and the inverse out-degree
read, the new ranks written, in the ranks' entry size, and 4 bytes of a
destination's offset).  The gathers of a source's rank through the ids are
not counted: the vector is read once, and what the L2 cache serves again
would let a count of them pass 100%.  Every byte is held against the HBM
peak; the few flops an arc are far below the float32 peak."""
from __future__ import annotations

from . import counts


def pagerank_bytes(n: int, arcs: int, iterations: int,
                   itemsize: int = 4) -> float:
    """Bytes of ``iterations`` power iterations."""
    return float(iterations) * (4.0 * arcs + n * (3.0 * itemsize + 4.0))


def pagerank_least_s(n: int, arcs: int, iterations: int,
                     itemsize: int = 4) -> float:
    """The least time the card could take for the iterations."""
    return pagerank_bytes(n, arcs, iterations, itemsize) \
        / counts.PEAK_HBM_BYTES
