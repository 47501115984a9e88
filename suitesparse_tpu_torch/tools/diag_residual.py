"""Residual against refinement steps with a float32 factor: the
counterpart of tools/diag_residual.py.

    python -m suitesparse_tpu_torch.tools.diag_residual [matrix] [steps]

Factors the matrix (default lap3d_20) in float32 through
``factorize_super`` and prints the residual after 0..steps float64
refinement steps (default 8), with each step's max |r| and |d|, for each
combination of ``Common.cholesky.trsm_inv`` (True: panel_factor's
explicit inverse; False: the backward-stable triangular solve) and
``Common.cholesky.program`` ("pf" or "wave").  These fields stand in for
the reference's ``SSTPU_TRSM_INV`` and ``SSTPU_POTRF`` environment
variables.  Runs on the card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import sys

import numpy as np

from ..utils.device import resolve_device

__all__ = ["main", "residuals"]

CASES = ((True, "pf"), (False, "pf"), (True, "wave"), (False, "wave"))


def residuals(A, steps: int, trsm_inv: bool = True, program: str = "pf",
              device=None) -> list:
    """[(residual, max|r|, max|d|)] after 0..steps float64 refinement
    steps of a float32 factor of A (|r| and |d| None at step 0)."""
    from ..cholesky import (analyze, factorize_super, residual_norm,
                            solve_super, super_symbolic)
    from ..core.common import default_common
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = program
    cm.cholesky.trsm_inv = trsm_inv
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    f = factorize_super(A, sym, ss, common=cm, dtype=np.float32,
                        device=resolve_device(device))
    b = np.ones(A.ncol)
    Sf = A.to_scipy().astype(np.float64)
    x = solve_super(f, b, "A", cm).astype(np.float64)
    out = [(residual_norm(A, x, b), None, None)]
    for _ in range(steps):
        r = b - Sf @ x
        d = np.asarray(solve_super(f, r, "A", cm), dtype=np.float64)
        x = x + d
        out.append((residual_norm(A, x, b), float(np.abs(r).max()),
                    float(np.abs(d).max())))
    return out


def main(name: str = "lap3d_20", steps: int = 8, device=None) -> dict:
    """Print and return each case's residual history."""
    from ..io.generators import symmetrize_upper, synthetic_standin
    dev = resolve_device(device)
    A = synthetic_standin(name)
    if A is None:
        raise ValueError(f"{name!r} is not a synthetic matrix name")
    if A.stype == 0:
        A = symmetrize_upper(A)
    out = {}
    for trsm_inv, program in CASES:
        hist = out[(trsm_inv, program)] = residuals(A, steps, trsm_inv,
                                                    program, dev)
        print(f"[{name}] n={A.ncol} trsm_inv={trsm_inv} program={program} "
              f"({dev.type})", flush=True)
        print(f"  step 0: residual {hist[0][0]:.3e}", flush=True)
        for k, (res, r, d) in enumerate(hist[1:], 1):
            print(f"  step {k}: residual {res:.3e}  ||r||={r:.3e} "
                  f"||d||={d:.3e}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "lap3d_20",
         int(sys.argv[2]) if len(sys.argv) > 2 else 8)
