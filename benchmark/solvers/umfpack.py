"""The UMFPACK front end of suitesparse_tpu_torch, as an implicit or
Newton code drives it: ``umf_symbolic`` once per pattern, then on each
iteration ``umf_numeric`` on new values of the same pattern and
``umf_solve`` with the original matrix, so that UMFPACK's iterative
refinement runs (at most ``refine_steps`` float64 host residuals), with
host matrices and host vectors.  The configuration's ``umfpack`` keys set
the ``Common.lu`` options they name; the rest stay as
``default_common()`` has them.

Steps (a mix names one in its ``step``):

``step_refactor_solve``  factor the step's value set, then solve with its
                         right-hand side (Newton);
``step_solve``           solve with the step's right-hand side on the
                         current numeric.

Each returns the answer the judge reads: (value set, right-hand side,
solution).  This file also reads the program's counters (the LU program's
warm-up and capture seconds and graph nodes, the supernodes' sizes for the
work count) and hands the current factor to the judge as
P R^-1 A Q C^-1 = L U (``umf_get_numeric``, imported here so that a
program without it fails at once).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.core.sparse import SparseCSC
from suitesparse_tpu_torch.lu.multifrontal import (umf_get_numeric,
                                                   umf_numeric, umf_program,
                                                   umf_solve, umf_symbolic)
from suitesparse_tpu_torch.utils.device import resolve_device


class Driver:
    """One configuration's matrix pattern on one device.

    A0:     the configuration's matrix (SciPy CSC, square), whose pattern
            every value set shares.
    config: the configuration (its ``dtype``: the factor's; ``umfpack``:
            ``Common.lu`` options).
    spans:  the harness's span recorder (``harness.tracing.Spans``)."""

    def __init__(self, A0: sp.csc_matrix, config: dict, device, spans):
        self.A0 = A0
        self.dtype = np.dtype(config["dtype"])
        self.device = torch.device(device)
        self.spans = spans
        self.cm = default_common()
        for key, value in config.get("umfpack", {}).items():
            if not hasattr(self.cm.lu, key):
                raise ValueError(f"Common.lu has no option {key!r}")
            setattr(self.cm.lu, key, value)
        self.S = None
        self.num = None
        self.matrices = []
        self.current = None     # the value set the numeric holds

    def matrix(self, data: np.ndarray) -> SparseCSC:
        """A host matrix with the pattern of A0 and the values ``data``."""
        return SparseCSC(self.A0.indptr, self.A0.indices, data, self.A0.shape)

    def set_values(self, values) -> None:
        """The value sets the steps factor, made into host matrices before
        the window."""
        self.matrices = [self.matrix(v) for v in values]

    def analyze(self) -> None:
        with self.spans("analyze"):
            self.S = umf_symbolic(self.matrix(self.A0.data), self.cm)

    def refactor(self, v: int) -> None:
        with self.spans("refactorize"):
            # the last numeric is freed first (umfpack_free_numeric)
            self.num = None
            self.num = umf_numeric(self.matrices[v], self.S, self.cm,
                                   dtype=self.dtype, device=self.device)
        self.current = v

    def solve(self, b: np.ndarray) -> np.ndarray:
        with self.spans("solve"):
            return umf_solve(self.num, b, A=self.matrices[self.current],
                             common=self.cm)

    def step_refactor_solve(self, pools, i: int) -> tuple:
        v, r = pools.step(i)
        self.refactor(v)
        return v, r, self.solve(pools.rhs[r])

    def step_solve(self, pools, i: int) -> tuple:
        r = pools.step(i)[1]
        return self.current, r, self.solve(pools.rhs[r])

    def counters(self) -> dict:
        """The program's own counts after set-up: the LU program's (the
        one ``umf_numeric`` ran, cached on the symbolic's plan) and the
        supernodes' sizes (a BTF symbolic, factored block by block, has
        neither)."""
        out = dict(program="umf", itemsize=self.dtype.itemsize)
        ss = self.S.ss
        if ss is None:
            return out
        prog = umf_program(self.S, self.dtype, resolve_device(self.device))
        if prog.graph is not None:
            out.update(warmup_s=prog.warmup_s, capture_s=prog.capture_s,
                       graph_nodes=prog.nodes)
        cols = np.diff(ss.super)
        out["lu_fronts"] = dict(cols=cols,
                                rows_below=np.diff(ss.sn_rowptr) - cols)
        return out

    def factor(self) -> dict:
        """The current numeric as the judge reads it: the relation it
        claims, P R^-1 A Q C^-1 = L U, with L (unit lower, its diagonal
        stored) and U as SciPy CSC matrices, P and Q (row k of the
        factored matrix is row P[k] of A, column k is column Q[k]), Rs (a
        scale of each row of A) and Cs (of each column of the factored
        matrix), and the value set whose matrix it factors."""
        f = umf_get_numeric(self.num)
        return dict(relation="PRAQC=LU", values=self.current, **f)

    def close(self) -> None:
        """Drop the program's state (numeric, symbolic, plans, captured
        graphs)."""
        self.num = None
        self.S = None
        self.matrices = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
