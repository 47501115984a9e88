"""CHOLMOD-equivalent top-level API: analyze / factorize / solve / backslash.

Counterpart of suitesparse_tpu/cholesky/api.py.  The 3-phase contract:
``analyze`` returns a reusable symbolic object; ``factorize`` produces a
numeric factor for any matrix with the same pattern; ``solve`` handles the
cholmod_solve system set.  It dispatches simplicial vs supernodal by the
flops/lnz switch (cholmod_core.h:458-465) as cholmod_factorize does.

One addition to the reference: ``device``, passed to ``factorize_super``.
The supernodal real path runs on the card unless the caller asks for the
CPU (and raises without a card); complex matrices and the simplicial
switch run the host NumPy code, as in the reference.  Solves return host
arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import SparseCSC
from . import simplicial as _simpl
from . import super_numeric as _supn
from .simplicial import Factor
from .supernodal import SuperSymbolic, super_symbolic
from .super_numeric import NumericPlan, SuperFactor, build_plan, factorize_super
from .symbolic import Symbolic, analyze


@dataclasses.dataclass
class CholeskySolver:
    """Stateful analyze-once / factorize-many handle (cholmod common use).

    device: where the supernodal factor lives ("cuda" when None)."""

    sym: Symbolic
    common: Common
    ss: Optional[SuperSymbolic] = None
    plan: Optional[NumericPlan] = None
    factor: Union[Factor, SuperFactor, None] = None
    device: object = None

    def refactorize(self, A: SparseCSC, ll: bool = True,
                    dtype=None) -> "CholeskySolver":
        # the supernodal programs are real-only (the symmetrize / SYRK
        # steps have no conjugate transpose): complex matrices take the
        # simplicial path
        if self.sym.is_super and not np.iscomplexobj(A.data):
            if self.ss is None:
                self.ss = super_symbolic(A, self.sym, self.common)
                self.plan = build_plan(self.ss)
            self.factor = factorize_super(A, self.sym, self.ss, self.plan,
                                          self.common, dtype=dtype,
                                          device=self.device)
        else:
            self.factor = _simpl.factorize_simplicial(A, self.sym,
                                                      self.common, ll=ll)
        return self

    def solve(self, b: np.ndarray, system: str = "A") -> np.ndarray:
        if self.factor is None:
            raise RuntimeError("factorize before solve")
        if isinstance(self.factor, SuperFactor):
            return _supn.solve_super(self.factor, b, system)
        return _simpl.solve(self.factor, b, system)


def cholesky(A: SparseCSC, common: Optional[Common] = None,
             perm: Optional[np.ndarray] = None,
             mode: Optional[str] = None, dtype=None,
             device=None) -> CholeskySolver:
    """analyze + factorize in one call.

    mode: None/'auto' (supernodal switch), 'simplicial', 'supernodal'
    (Common.cholesky.supernodal override).  device: as CholeskySolver's.
    """
    cm = common or default_common()
    if mode is not None and mode != "auto":
        cm.cholesky.supernodal = mode
    sym = analyze(A, cm, perm=perm)
    return CholeskySolver(sym=sym, common=cm, device=device).refactorize(
        A, dtype=dtype)


def spsolve_chol(A: SparseCSC, b: np.ndarray,
                 common: Optional[Common] = None, dtype=None,
                 refine_steps: Optional[int] = None,
                 device=None) -> np.ndarray:
    """x = A \\ b for SPD A, with iterative refinement in float64 on the
    host when the factor dtype is narrower than the rhs (the f32 factor +
    f64 residual path)."""
    cm = common or default_common()
    solver = cholesky(A, cm, dtype=dtype, device=device)
    x = solver.solve(b).astype(np.float64)
    steps = cm.cholesky.refine_steps if refine_steps is None else refine_steps
    if steps > 0:
        S = A.to_scipy()
        for _ in range(steps):
            r = b - S @ x
            if np.linalg.norm(r, np.inf) == 0:
                break
            x = x + solver.solve(r).astype(np.float64)
    return x


def residual_norm(A: SparseCSC, x: np.ndarray, b: np.ndarray) -> float:
    """The reference residual protocol: ||Ax-b||_inf / (||A||_1 ||x||_inf +
    ||b||_inf) (CHOLMOD/Demo/cholmod_demo.c:453-503, cs_demo.c:52-60)."""
    S = A.to_scipy()
    r = S @ x - b
    denom = A.norm(1) * np.abs(x).max(initial=0.0) + np.abs(b).max(initial=0.0)
    return float(np.abs(r).max(initial=0.0) / max(denom, np.finfo(float).tiny))
