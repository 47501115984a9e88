"""The plain reference that decides ``correct`` for the PageRank front end
(``solvers/graphblas.py``) on an undirected graph given by the strictly
lower triangle L of its adjacency (``generators/kron_g500.py``): plain
PyTorch in float64 on the run's device, with code of its own.  It imports
nothing of the program.

The graph is A = L + L^T: arcs i -> j and j -> i for each stored L_ij
(a stored diagonal entry is one self-loop arc), out-degree d_i the number
of arcs leaving i.  From uniform ranks r_0 = 1/n, each iteration is

    y_j = sum over arcs i -> j of r_i / max(d_i, 1)
    r'  = DAMPING y + (1 - DAMPING) / n
    r'  = r' + (sum(r) - sum(r')) / n        (dangling mass spread evenly)

and the loop stops after the iteration whose L1 change ||r' - r||_1 is at
most TOL, or after MAX_ITER iterations: GAP's PageRank kernel (Beamer et
al., arXiv:1508.03619: damping 0.85, tolerance 1e-4, at most 20
iterations) with the dangling mass of LAGraph's LAGr_PageRank and of the
program.  The product runs over L's entries a block of columns at a time
(at most BLOCK entries), scattered into y by ``index_add_`` in both
directions, so that the card holds L's row ids, one block's temporaries
and a few vectors of n.

Each answer is (k, r): the iterations the program ran and its ranks.

``pr_l1_err``    ||r - r_ref(k)||_1, r_ref(k) the reference's iterate
                 after k iterations (its own stop aside): compared at the
                 same k, the limit is about precision and not about a stop
                 that falls one iteration early or late (one iteration
                 moves the ranks by about TOL in L1).
``pr_iter_gap``  |k - k_ref|, k_ref the reference's own stop.

An answer with k outside [0, MAX_ITER], of the wrong length, or with a NaN
or an Inf reads as +inf on ``pr_l1_err``.

The control is this loop in a lower precision put in the program's place:
``ranks(Graph(L, dev, torch.bfloat16))`` gives (k, r) as the program
would, with the products, sums and stop test in bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

DAMPING = 0.85
TOL = 1e-4
MAX_ITER = 20
BLOCK = 1 << 26     # entries of L in one block of the product
F64 = torch.float64


class Graph:
    """A = L + L^T on ``dev``: L's row ids (as stored), the column blocks
    and 1 / max(d, 1) in ``dtype``, the ranks' (the degrees are counted
    in float64)."""

    def __init__(self, L, dev, dtype=F64):
        self.n = n = L.shape[0]
        self.dev = dev
        indptr = np.asarray(L.indptr, dtype=np.int64)
        self.rows = torch.as_tensor(np.asarray(L.indices), device=dev)
        # block edges: columns where the entries before them pass a
        # multiple of BLOCK, so that no block holds more than BLOCK
        # entries unless one column does
        cuts = np.searchsorted(indptr, np.arange(BLOCK, indptr[-1], BLOCK),
                               side="right") - 1
        edges = np.unique(np.concatenate([[0], cuts, [n]]))
        self.blocks = [(int(a), int(b), int(indptr[a]), int(indptr[b]))
                       for a, b in zip(edges[:-1], edges[1:])]
        self.lens = torch.as_tensor(np.diff(indptr), device=dev)
        deg = torch.zeros(n, dtype=F64, device=dev)
        for r, c in self._entries():
            off = r != c
            deg += torch.bincount(c, minlength=n)
            deg += torch.bincount(r[off], minlength=n)
        self.dinv = (1.0 / torch.clamp(deg, min=1.0)).to(dtype)

    def _entries(self):
        """(row, column) of L's entries, int64, a block at a time."""
        for a, b, p, q in self.blocks:
            c = torch.repeat_interleave(
                torch.arange(a, b, device=self.dev), self.lens[a:b])
            yield self.rows[p:q].long(), c

    def step(self, r: torch.Tensor) -> torch.Tensor:
        x = r * self.dinv
        y = torch.zeros_like(r)
        for i, j in self._entries():
            y.index_add_(0, j, x[i])          # arc i -> j
            off = i != j
            y.index_add_(0, i[off], x[j[off]])   # arc j -> i
        rnew = DAMPING * y + (1.0 - DAMPING) / self.n
        return rnew + (r.sum() - rnew.sum()) / self.n


def iterates(g: Graph):
    """(k, r_k, ||r_k - r_(k-1)||_1) for k = 0, 1, ... without end, from
    uniform ranks in the graph's dtype (the change of r_0 is inf)."""
    r = torch.full((g.n,), 1.0 / g.n, dtype=g.dinv.dtype, device=g.dev)
    k, delta = 0, np.inf
    while True:
        yield k, r, delta
        rnew = g.step(r)
        delta = float((rnew - r).abs().sum())
        r, k = rnew, k + 1


def stops(k: int, delta: float) -> bool:
    """The loop ends at iterate k: its change is within TOL, or the cap."""
    return not (delta > TOL and k < MAX_ITER)


def ranks(g: Graph) -> tuple:
    """The loop to its own stop: (iterations, ranks)."""
    for k, r, delta in iterates(g):
        if stops(k, delta):
            return k, r


def _l1(answer, r: torch.Tensor) -> float:
    a = np.asarray(answer)
    if a.shape != (r.numel(),):
        return float("inf")
    d = float((torch.as_tensor(a, device=r.device).to(F64) - r).abs().sum())
    return d if np.isfinite(d) else float("inf")


def judge(case) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = Graph(case.A0, case.device)
    ks = np.array([int(k) for k, _ in case.answers], dtype=np.int64)
    err = np.full(len(ks), np.inf)
    top = int(ks[(ks >= 0) & (ks <= MAX_ITER)].max(initial=0))
    k_ref = None
    for it, r, delta in iterates(g):
        for a in np.flatnonzero(ks == it):
            err[a] = _l1(case.answers[a][1], r)
        if k_ref is None and stops(it, delta):
            k_ref = it
        if k_ref is not None and it >= top:
            break
    gap = np.abs(ks - k_ref).astype(np.float64)
    return {"values": {"pr_l1_err": float(err.max(initial=0.0)),
                       "pr_iter_gap": float(gap.max(initial=0.0))},
            "per_answer": {"pr_l1_err": err, "pr_iter_gap": gap}}
