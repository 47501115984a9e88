"""The plain reference that decides ``correct`` for an LU front end:
normwise backward errors, in float64, of what the program returned, by
plain PyTorch sparse products (on the card after the window, or on the
CPU).  It takes the matrices and right-hand sides the benchmark made, and
reads the program's outputs (solutions, and the factor with its
permutations and scalings) only to judge them.  It imports nothing of the
program.

``solve_berr``      ||A x - b||_inf / (||A||_inf ||x||_inf + ||b||_inf) of
                    each solution, the formula of ``backward_error.py``
                    (a judge imports no other file, so it is written out
                    here), ||A||_inf the largest row sum of the
                    unsymmetric A.
``lu_factor_berr``  ||(P R^-1 A Q C^-1 - L U) z||_inf
                    / (||R^-1 A C^-1||_inf ||z||_inf), the largest over
                    FACTOR_PROBES random probes z drawn from the seed: a
                    Freivalds check of the relation the factor claims
                    (``PRAQC=LU``: row k of the factored matrix is row P[k]
                    of A scaled by 1 / Rs[P[k]], column k is column Q[k]
                    scaled by 1 / Cs[k]; L unit lower with its diagonal
                    stored, U upper).

``judge``           ``solve_berr`` over every answer and ``lu_factor_berr``
                    of the current factor.

A NaN (a failed pivot) or an Inf reads as +inf, which no limit passes.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

RELATION = "PRAQC=LU"
F64 = torch.float64
FACTOR_PROBES = 4   # random probes of the factor's backward error
BLOCK = 256         # solutions judged together in one sparse product


def norm_inf(A: sp.spmatrix) -> float:
    return float(abs(A).sum(axis=1).max())


def _t(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device,
                           dtype=dtype)


def _coo(M: sp.spmatrix, device) -> tuple:
    """(rows, cols, values) of M as int64 / float64 tensors on
    ``device``."""
    M = sp.coo_matrix(M)
    return (_t(M.row, device, torch.int64), _t(M.col, device, torch.int64),
            _t(M.data, device, F64))


def _apply(M: tuple, z: torch.Tensor) -> torch.Tensor:
    """M z for M as (rows, cols, values) and z (n,) or (n, k): a scatter
    of each entry."""
    rows, cols, vals = M
    v = vals if z.dim() == 1 else vals[:, None]
    return torch.zeros_like(z).index_add_(0, rows, v * z[cols])


def answers_berr(case) -> np.ndarray:
    """||A x - b||_inf / (||A||_inf ||x||_inf + ||b||_inf) of every answer
    of the run (the largest over an answer's columns), judged a value set
    and a block at a time; a NaN or an Inf reads as +inf."""
    n = case.A0.shape[0]
    out = np.empty(len(case.answers))
    for v in sorted({a[0] for a in case.answers}):
        Av = case.matrix(v)
        nA = norm_inf(Av)
        Am = _coo(Av, case.device)
        idx = [k for k, a in enumerate(case.answers) if a[0] == v]
        for j in range(0, len(idx), BLOCK):
            blk = idx[j:j + BLOCK]
            # one column per solution column
            X = np.concatenate([case.answers[k][2].reshape(n, -1)
                                for k in blk], axis=1)
            B = np.concatenate([case.rhs[case.answers[k][1]].reshape(n, -1)
                                for k in blk], axis=1)
            x = _t(X, case.device, F64)
            b = _t(B, case.device, F64)
            r = (_apply(Am, x) - b).abs().amax(dim=0)
            den = nA * x.abs().amax(dim=0) + b.abs().amax(dim=0)
            e = (r / den.clamp_min(torch.finfo(F64).tiny)).cpu().numpy()
            e = np.where(np.isfinite(e), e, np.inf)
            out[blk] = e.reshape(len(blk), -1).max(axis=1)
    return out


def lu_factor_berr(A: sp.spmatrix, f: dict, Z: np.ndarray,
                   device="cpu") -> float:
    """Largest backward error of the claim P R^-1 A Q C^-1 = L U (``f``:
    L, U, P, Q, Rs, Cs) over the probe columns of Z."""
    n = A.shape[0]
    P = np.asarray(f["P"], dtype=np.int64)
    Q = np.asarray(f["Q"], dtype=np.int64)
    col_scale = np.empty(n)
    col_scale[Q] = np.asarray(f["Cs"], dtype=np.float64)
    As = sp.diags(1.0 / np.asarray(f["Rs"], dtype=np.float64)) \
        @ sp.csc_matrix(A, dtype=np.float64) @ sp.diags(1.0 / col_scale)
    nA = norm_inf(As)
    Am = _coo(As, device)
    L = _coo(f["L"], device)
    U = _coo(f["U"], device)
    P_t = _t(P, device, torch.int64)
    Q_t = _t(Q, device, torch.int64)
    worst = 0.0
    for z_host in np.asarray(Z, dtype=np.float64).T:
        z = _t(z_host, device, F64)
        u = torch.empty_like(z)
        u[Q_t] = z                                    # Q z
        lhs = _apply(Am, u)[P_t]                      # P R^-1 A Q C^-1 z
        rhs = _apply(L, _apply(U, z))                 # L U z
        err = float((lhs - rhs).abs().max()) / (nA * float(z.abs().max()))
        worst = max(worst, err if np.isfinite(err) else np.inf)
    return float(worst)


def judge(case) -> dict:
    """Every answer's backward error, and the current factor's over
    FACTOR_PROBES random probes drawn from the seed."""
    e = answers_berr(case)
    values = {"solve_berr": float(e.max(initial=0.0))}
    f = case.factor
    if f is None or f["relation"] != RELATION:
        raise ValueError(f"the front end claims no {RELATION} factor")
    rng = np.random.default_rng([case.seed, 1])
    Z = rng.standard_normal((case.A0.shape[0], FACTOR_PROBES))
    values["lu_factor_berr"] = lu_factor_berr(case.matrix(f["values"]), f, Z,
                                              case.device)
    return {"values": values, "per_answer": {"solve_berr": e}}
