"""The plain reference that decides ``correct``: normwise backward errors,
in float64, of what the program returned, by plain PyTorch sparse products
(on the card after the window, or on the CPU).

It takes the matrices and right-hand sides the benchmark made, and reads
the program's outputs (solutions, and a factor with its permutation) only
to judge them.  It imports nothing of the program.

``solve_berr``  ||A x - b||_inf / (||A||_inf ||x||_inf + ||b||_inf) of each
                solution: the residual protocol of CHOLMOD's demo
                (CHOLMOD/Demo/cholmod_demo.c), with ||A||_1 = ||A||_inf for a
                symmetric A.
``factor_berr`` ||(P A P' - L L') z||_inf / (||A||_inf ||z||_inf), the
                largest over a few random probes z: a Freivalds check of the
                factor, with P A P' = L L' the relation the factor claims
                (row k of P A P' is row perm[k] of A).

``judge``        the default judge of a configuration (one that names no
                other in its ``judge``): ``solve_berr`` over every answer and
                ``factor_berr`` of the current factor, which the front end
                claims as P A P' = L L' or L D L'.

A NaN (a failed pivot) or an Inf reads as +inf, which no limit passes.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

BLOCK = 256     # solutions judged together in one sparse product
F64 = torch.float64
FACTOR_PROBES = 4   # random probes of the factor's backward error


def norm_inf(A: sp.spmatrix) -> float:
    return float(abs(A).sum(axis=1).max())


def _finite(v: np.ndarray) -> np.ndarray:
    return np.where(np.isfinite(v), v, np.inf)


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device,
                           dtype=dtype)


def csr(A: sp.spmatrix, device) -> torch.Tensor:
    """A as a float64 sparse CSR tensor on ``device``."""
    A = sp.csr_matrix(A)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse")
        return torch.sparse_csr_tensor(_t(A.indptr, device, torch.int64),
                                       _t(A.indices, device, torch.int64),
                                       _t(A.data, device, F64), size=A.shape,
                                       check_invariants=False)


def solve_berr(A: sp.spmatrix, X: np.ndarray, B: np.ndarray,
               device="cpu") -> np.ndarray:
    """Backward error of each row of X (m, n) as a solution of A x = b,
    b the same row of B."""
    X = np.atleast_2d(X)
    B = np.atleast_2d(B)
    nA = norm_inf(A)
    As = csr(A, device)
    out = np.empty(X.shape[0])
    for j in range(0, X.shape[0], BLOCK):
        x = _t(X[j:j + BLOCK], device, F64).T
        b = _t(B[j:j + BLOCK], device, F64).T
        r = (As @ x - b).abs().amax(dim=0)
        den = nA * x.abs().amax(dim=0) + b.abs().amax(dim=0)
        e = r / den.clamp_min(torch.finfo(F64).tiny)
        out[j:j + BLOCK] = e.cpu().numpy()
    return _finite(out)


def factor_berr(A: sp.spmatrix, perm: np.ndarray, L: sp.spmatrix,
                Z: np.ndarray, device="cpu", D=None) -> float:
    """Largest backward error of the factor L (with P A P' = L L', or
    L D L' where D is given) over the probe columns of Z.  L L' z is taken
    column by column of L's CSC arrays: L' z as a sum over each column,
    L y as a scatter of each column."""
    L = sp.csc_matrix(L)
    n = L.shape[0]
    rows = _t(L.indices, device, torch.int64)
    cols = torch.repeat_interleave(
        torch.arange(n, device=device),
        _t(np.diff(L.indptr), device, torch.int64))
    vals = _t(L.data, device, F64)
    As = csr(A, device)
    perm_t = _t(perm, device, torch.int64)
    d = None if D is None else _t(D, device, F64)
    nA = norm_inf(A)
    worst = 0.0
    for z_host in np.asarray(Z, dtype=np.float64).T:
        z = _t(z_host, device, F64)
        u = torch.empty_like(z)
        u[perm_t] = z                                    # P' z
        lhs = (As @ u[:, None])[:, 0][perm_t]            # P A P' z
        y = torch.zeros_like(z).index_add_(0, cols, vals * z[rows])  # L' z
        if d is not None:
            y = d * y
        rhs = torch.zeros_like(z).index_add_(0, rows, vals * y[cols])  # L y
        err = float((lhs - rhs).abs().max()) / (nA * float(z.abs().max()))
        worst = max(worst, err if np.isfinite(err) else np.inf)
    return float(worst)


def answers_berr(case) -> np.ndarray:
    """``solve_berr`` of every answer of the run (the largest over an
    answer's columns), judged a value set and a block at a time."""
    n = case.A0.shape[0]
    out = np.empty(len(case.answers))
    for v in sorted({a[0] for a in case.answers}):
        Av = case.matrix(v)
        idx = [k for k, a in enumerate(case.answers) if a[0] == v]
        for j in range(0, len(idx), BLOCK):
            blk = idx[j:j + BLOCK]
            # one row per solution column: rows stack contiguously
            X = np.concatenate([case.answers[k][2].reshape(n, -1).T
                                for k in blk])
            B = np.concatenate([case.rhs[case.answers[k][1]].reshape(n, -1).T
                                for k in blk])
            e = solve_berr(Av, X, B, case.device)
            out[blk] = e.reshape(len(blk), -1).max(axis=1)
    return out


def judge(case) -> dict:
    """The default judge: every answer's backward error, and the current
    factor's over FACTOR_PROBES random probes drawn from the seed."""
    e = answers_berr(case)
    values = {"solve_berr": float(e.max(initial=0.0))}
    f = case.factor
    if f is not None:
        if f["relation"] not in ("PAP'=LL'", "PAP'=LDL'"):
            raise ValueError(f"no check of a factor {f['relation']!r}")
        rng = np.random.default_rng([case.seed, 1])
        Z = rng.standard_normal((case.A0.shape[0], FACTOR_PROBES))
        values["factor_berr"] = factor_berr(case.matrix(f["values"]),
                                            f["perm"], f["L"], Z,
                                            case.device, D=f.get("D"))
    return {"values": values, "per_answer": {"solve_berr": e}}
