"""The Cholesky front end of suitesparse_tpu_torch, as a Newton or
time-stepping code drives it: ``analyze`` once, then
``CholeskySolver.refactorize(A)`` on new values of the same pattern and
``CholeskySolver.solve(b)``, with host matrices and host vectors, under
``default_common()`` as it stands.

Steps (a mix names one in its ``step``):

``step_refactor_solve``  refactorize with the step's value set, then solve
                         with its right-hand side (Newton, interior point);
``step_solve``           solve with the step's right-hand side on the
                         current factor (time stepping, load cases).

Each returns the answer the judge reads: (value set, right-hand side,
solution).  This file also reads the program's counters (warm-up and
capture seconds, graph nodes, the program the pattern resolves to, the pf
plan's block_chol shapes) and hands the current factor to the judge.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from suitesparse_tpu_torch.cholesky import pf
from suitesparse_tpu_torch.cholesky.api import CholeskySolver, analyze
from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.core.sparse import SparseCSC


class Driver:
    """One configuration's matrix pattern on one device.

    A0:     the configuration's matrix (SciPy CSC, symmetric, stored in
            full), whose pattern every value set shares.
    config: the configuration (its ``dtype``: the factor's).
    spans:  the harness's span recorder (``harness.tracing.Spans``)."""

    def __init__(self, A0: sp.csc_matrix, config: dict, device, spans):
        self.A0 = A0
        self.dtype = np.dtype(config["dtype"])
        self.device = torch.device(device)
        self.spans = spans
        self.cm = default_common()
        self.solver = None
        self.matrices = []
        self.current = None     # the value set the factor holds

    def matrix(self, data: np.ndarray) -> SparseCSC:
        """A host matrix with the pattern of A0 and the values ``data``."""
        return SparseCSC(self.A0.indptr, self.A0.indices, data, self.A0.shape)

    def set_values(self, values) -> None:
        """The value sets the steps refactorize with, made into host
        matrices before the window."""
        self.matrices = [self.matrix(v) for v in values]

    def analyze(self) -> None:
        with self.spans("analyze"):
            sym = analyze(self.matrix(self.A0.data), self.cm)
        self.solver = CholeskySolver(sym=sym, common=self.cm,
                                     device=self.device)

    def refactor(self, v: int) -> None:
        with self.spans("refactorize"):
            self.solver.refactorize(self.matrices[v], dtype=self.dtype)
        self.current = v

    def solve(self, b: np.ndarray) -> np.ndarray:
        with self.spans("solve"):
            return self.solver.solve(b)

    def step_refactor_solve(self, pools, i: int) -> tuple:
        v, r = pools.step(i)
        self.refactor(v)
        return v, r, self.solve(pools.rhs[r])

    def step_solve(self, pools, i: int) -> tuple:
        r = pools.step(i)[1]
        return self.current, r, self.solve(pools.rhs[r])

    def counters(self) -> dict:
        """The program's own counts after set-up."""
        s = self.solver
        info = self.cm.info
        out = dict(program=s.plan.resolve_program(self.cm) if s.plan
                   else "simplicial",
                   warmup_s=info.get("factor_warmup_time"),
                   capture_s=info.get("factor_capture_time"),
                   graph_nodes=info.get("factor_graph_nodes"),
                   itemsize=self.dtype.itemsize)
        if out["program"] == "pf":
            pfp = s.plan.pf_plan(self.cm)
            out["block_chol"] = dict(fmeta=pfp.fmeta,
                                     instr_cls=np.asarray(pfp.instr_cls),
                                     potrf_maxnp=pf._POTRF_MAXNP,
                                     trsm_inv=self.cm.cholesky.trsm_inv)
        return out

    def factor(self) -> dict:
        """The current factor as the judge reads it: the relation it
        claims, P A P' = L L' (or L D L', L unit lower), with ``perm``
        (row k of P A P' is row perm[k] of A), L a SciPy CSC matrix of the
        factor's values (a supernodal factor through its conversion to the
        simplicial form, cholmod_change_factor's), D where LDL', and the
        value set whose matrix it factors."""
        F = self.solver.factor
        if hasattr(F, "to_simplicial"):
            F = F.to_simplicial()
        n = self.A0.shape[0]
        L = sp.csc_matrix((F.Lx, F.Li, F.Lp), shape=(n, n))
        claim = dict(values=self.current, perm=np.asarray(F.perm), L=L)
        if F.is_ll:
            return dict(claim, relation="PAP'=LL'")
        L.setdiag(1.0)
        return dict(claim, relation="PAP'=LDL'", D=np.asarray(F.D))

    def close(self) -> None:
        """Drop the program's state (factor, plans, captured graphs)."""
        self.solver = None
        self.matrices = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
