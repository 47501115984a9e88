"""meshnd: regular 2D/3D mesh generation + exact nested dissection.

Counterpart of suitesparse_tpu/models/meshnd.py, copied.

MATLAB_Tools/MESHND parity (meshnd.m / meshsparse.m behavior): build an
m x n (x k) mesh of vertex ids, order it by recursive middle-plane nested
dissection (the EXACT geometric split, not the graph-partitioner nesdis),
and build the mesh Laplacian-stencil matrix.  Independent implementation
over numpy index arrays.
"""
from __future__ import annotations

import numpy as np

from ..core.sparse import INDEX, SparseCSC

__all__ = ["meshnd", "meshsparse"]


def _nd_order(G: np.ndarray, out: list):
    """Recursive nested dissection of the index grid G (any ndim<=3):
    split along the LONGEST dimension's middle plane; children first,
    separator last (meshnd.m ordering)."""
    shape = G.shape
    if G.size == 0:
        return
    if max(shape) <= 2:
        out.extend(G.reshape(-1).tolist())
        return
    ax = int(np.argmax(shape))
    mid = shape[ax] // 2
    sl = [slice(None)] * G.ndim
    lo, se, hi = list(sl), list(sl), list(sl)
    lo[ax] = slice(0, mid)
    se[ax] = slice(mid, mid + 1)
    hi[ax] = slice(mid + 1, None)
    _nd_order(G[tuple(lo)], out)
    _nd_order(G[tuple(hi)], out)
    out.extend(G[tuple(se)].reshape(-1).tolist())


def meshnd(m: int, n: int, k: int = 1):
    """Returns (G, p, pinv, Gnew): the mesh id grid, the nested-dissection
    permutation p (order in which to eliminate), its inverse, and the
    relabeled grid Gnew = pinv[G] + 1-free (0-based here)."""
    G = np.arange(m * n * k, dtype=INDEX).reshape(m, n, k)
    order: list = []
    _nd_order(G, order)
    p = np.array(order, dtype=INDEX)
    pinv = np.empty_like(p)
    pinv[p] = np.arange(len(p), dtype=INDEX)
    Gnew = pinv[G]
    if k == 1:
        G = G[:, :, 0]
        Gnew = Gnew[:, :, 0]
    return G, p, pinv, Gnew


def meshsparse(G: np.ndarray, stencil: int = 5) -> SparseCSC:
    """Mesh Laplacian for grid G (meshsparse.m): stencil 5/9 (2D) or
    7/27 (3D); diagonal = number of neighbors."""
    G3 = G[:, :, None] if G.ndim == 2 else G
    m, n, k = G3.shape
    if stencil in (5, 7):
        offs = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    elif stencil in (9, 27):
        offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]
    else:
        raise ValueError("stencil must be 5, 9, 7 or 27")
    rows, cols = [], []
    for dx, dy, dz in offs:
        a = G3[max(dx, 0):m + min(dx, 0), max(dy, 0):n + min(dy, 0),
               max(dz, 0):k + min(dz, 0)].reshape(-1)
        b = G3[max(-dx, 0):m + min(-dx, 0), max(-dy, 0):n + min(-dy, 0),
               max(-dz, 0):k + min(-dz, 0)].reshape(-1)
        rows.append(a)
        cols.append(b)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    N = m * n * k
    import scipy.sparse as sp
    Adj = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(N, N))
    Adj = Adj + Adj.T
    deg = np.asarray(Adj.sum(axis=1)).ravel()
    L = sp.diags(deg) - Adj
    return SparseCSC.from_scipy(L.tocsc())
