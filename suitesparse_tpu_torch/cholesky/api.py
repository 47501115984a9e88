"""Cholesky front-end helpers (counterpart of a part of
suitesparse_tpu/cholesky/api.py)."""
from __future__ import annotations

import numpy as np

from ..core.sparse import SparseCSC


def residual_norm(A: SparseCSC, x: np.ndarray, b: np.ndarray) -> float:
    """The reference residual protocol: ||Ax-b||_inf / (||A||_1 ||x||_inf +
    ||b||_inf) (CHOLMOD/Demo/cholmod_demo.c:453-503, cs_demo.c:52-60)."""
    S = A.to_scipy()
    r = S @ x - b
    denom = A.norm(1) * np.abs(x).max(initial=0.0) + np.abs(b).max(initial=0.0)
    return float(np.abs(r).max(initial=0.0) / max(denom, np.finfo(float).tiny))
