"""The plain reference that decides ``correct`` for a least-squares front
end on a weighted normal matrix (``generators/grid_normal_3d.py``): plain
PyTorch in float64 on the CPU, sparse products through
``torch.sparse_csr_tensor``.  It rebuilds each value set's least-squares
matrix A and each step's right-hand side b from the benchmark's own
inputs with code of its own, and reads the program's outputs (solutions,
and the factor R with its column order) only to judge them.  It imports
nothing of the program.

The value set's L (the configuration's pattern, ``case.values[v]``)
gives A = [diag(sqrt w) G; diag(sqrt excess)]: one row per strictly upper
entry L_ij (i < j) with -sqrt(w) at column i and +sqrt(w) at column j,
w = -L_ij, then one row per column c with sqrt(L_cc - sum_j |L_cj|) at c.
The traffic's N(0, 1) vector rho gives psi = wrap(pi rho) and
b = [sqrt(w) wrap(psi_j - psi_i); 0], wrap(t) = t - 2 pi round(t / 2 pi).

``ls_berr``         ||A^T (b - A x)||_2 / (||A||_F ||b - A x||_2) of each
                    answer: the least-squares optimality of x (A^T r = 0
                    at the solution), scaled so that it does not grow with
                    A or with the residual.
``qr_factor_berr``  ||(P^T A^T A P - R^T R) z||_inf
                    / (|| |A|^T |A| ||_inf ||z||_inf), the largest over
                    FACTOR_PROBES random probes z drawn from the seed: a
                    Freivalds check of A P = Q R through R^T R = P^T A^T
                    A P, which holds for every orthogonal Q (the row sums
                    of |A|^T |A| are those of |A^T A| here, since each
                    row of A pairs two entries of opposite sign or has
                    one).

``judge``           ``ls_berr`` over every answer and ``qr_factor_berr``
                    of the current factor.

A NaN or an Inf reads as +inf, which no limit passes.
"""
from __future__ import annotations

import numpy as np
import torch

RELATION = "AP=QR"
F64 = torch.float64
I64 = torch.int64
FACTOR_PROBES = 4   # random probes of the factor's backward error


def wrap(t: torch.Tensor) -> torch.Tensor:
    return t - 2.0 * np.pi * torch.round(t / (2.0 * np.pi))


class LeastSquares:
    """A of one value set, as CSR tensors of A and A^T, and sqrt(w) with
    each edge's ends, to make its right-hand sides."""

    def __init__(self, A0, data: np.ndarray):
        n = A0.shape[0]
        indptr = torch.as_tensor(np.asarray(A0.indptr, dtype=np.int64))
        row = torch.as_tensor(np.asarray(A0.indices, dtype=np.int64))
        col = torch.repeat_interleave(torch.arange(n), indptr.diff())
        v = torch.as_tensor(np.asarray(data, dtype=np.float64))
        off = row != col
        absum = torch.zeros(n, dtype=F64).index_add_(0, row[off],
                                                     v[off].abs())
        diag = torch.zeros(n, dtype=F64)
        diag[row[~off]] = v[~off]
        up = row < col
        self.i, self.j = row[up], col[up]
        self.sw = torch.sqrt(-v[up])
        ne = len(self.sw)
        e = torch.arange(ne)
        rows = torch.cat([e, e, ne + torch.arange(n)])
        cols = torch.cat([self.i, self.j, torch.arange(n)])
        vals = torch.cat([-self.sw, self.sw, torch.sqrt(diag - absum)])
        self.n, self.m = n, ne + n
        self.A = _csr(rows, cols, vals, (self.m, n))
        self.At = _csr(cols, rows, vals, (n, self.m))
        self.fro = float(torch.linalg.vector_norm(vals))
        self.absA = _csr(rows, cols, vals.abs(), (self.m, n))
        self.absAt = _csr(cols, rows, vals.abs(), (n, self.m))

    def rhs(self, rho: np.ndarray) -> torch.Tensor:
        psi = wrap(np.pi * torch.as_tensor(rho, dtype=F64))
        d = wrap(psi[self.j] - psi[self.i])
        return torch.cat([self.sw * d, torch.zeros(self.n, dtype=F64)])


def _csr(rows, cols, vals, shape) -> torch.Tensor:
    """The CSR tensor of the entries (rows, cols, vals), no duplicates."""
    order = torch.argsort(rows * shape[1] + cols)
    crow = torch.zeros(shape[0] + 1, dtype=I64)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=shape[0]), 0)
    return torch.sparse_csr_tensor(crow, cols[order], vals[order],
                                   size=shape, dtype=F64)


def _finite(x: float) -> float:
    return float(x) if np.isfinite(x) else float(np.inf)


def answers_berr(case) -> np.ndarray:
    """||A^T r||_2 / (||A||_F ||r||_2), r = b - A x, of every answer."""
    out = np.empty(len(case.answers))
    for v in sorted({a[0] for a in case.answers}):
        ls = LeastSquares(case.A0, case.values[v])
        for k, (av, r, x) in enumerate(case.answers):
            if av != v:
                continue
            xt = torch.as_tensor(np.asarray(x, dtype=np.float64))
            res = ls.rhs(case.rhs[r]) - ls.A @ xt
            g = ls.At @ res
            den = ls.fro * float(torch.linalg.vector_norm(res))
            out[k] = _finite(float(torch.linalg.vector_norm(g))
                             / max(den, np.finfo(np.float64).tiny))
    return out


def qr_factor_berr(ls: LeastSquares, f: dict, Z: np.ndarray) -> float:
    """Largest backward error of R^T R = P^T A^T A P (``f``: R, perm)
    over the probe columns of Z."""
    import scipy.sparse as sp
    R = sp.csc_matrix(f["R"], dtype=np.float64)
    Rr = R.tocsr()
    n = ls.n
    Rt = torch.sparse_csr_tensor(   # R^T's CSR is R's CSC
        torch.as_tensor(R.indptr.astype(np.int64)),
        torch.as_tensor(R.indices.astype(np.int64)),
        torch.as_tensor(R.data), size=(n, n), dtype=F64)
    Rm = torch.sparse_csr_tensor(
        torch.as_tensor(Rr.indptr.astype(np.int64)),
        torch.as_tensor(Rr.indices.astype(np.int64)),
        torch.as_tensor(Rr.data), size=(n, n), dtype=F64)
    perm = torch.as_tensor(np.asarray(f["perm"], dtype=np.int64))
    z = torch.as_tensor(np.asarray(Z, dtype=np.float64))
    u = torch.empty_like(z)
    u[perm] = z                                   # P z
    lhs = (ls.At @ (ls.A @ u))[perm]              # P^T A^T A P z
    rhs = Rt @ (Rm @ z)                           # R^T R z
    norm = float((ls.absAt @ (ls.absA @ torch.ones(n, dtype=F64))).max())
    err = ((lhs - rhs).abs().amax(dim=0)
           / (norm * z.abs().amax(dim=0))).numpy()
    return _finite(float(np.where(np.isfinite(err), err, np.inf).max()))


def judge(case) -> dict:
    """Every answer's ls_berr, and the current factor's backward error
    over FACTOR_PROBES random probes drawn from the seed."""
    e = answers_berr(case)
    values = {"ls_berr": float(e.max(initial=0.0))}
    f = case.factor
    if f is None or f["relation"] != RELATION:
        raise ValueError(f"the front end claims no {RELATION} factor")
    rng = np.random.default_rng([case.seed, 1])
    Z = rng.standard_normal((case.A0.shape[0], FACTOR_PROBES))
    ls = LeastSquares(case.A0, case.values[f["values"]])
    values["qr_factor_berr"] = qr_factor_berr(ls, f, Z)
    return {"values": values, "per_answer": {"ls_berr": e}}
