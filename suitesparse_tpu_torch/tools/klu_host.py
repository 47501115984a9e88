"""Time host KLU on ``circuit_like(n)``: klu_analyze, klu_factor,
klu_refactor and klu_solve in float64 on the host clock, with the solve's
residual and the factor's flop count.

    python3 -m suitesparse_tpu_torch.tools.klu_host [n]

prints one JSON line (n defaults to 20000, the reference's
``bench_extra.py`` default).  It raises when the native Gilbert-Peierls
kernel (``native/src/klu.cc``) cannot be loaded, so that a time it gives
is never one of the Python twin, and when the residual exceeds
RESIDUAL_MAX.  ``chip_smoke.py``'s ``[lu]`` phase runs ``run`` on
circuit_4000 before it drives the device twin.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

N_DEFAULT = 20000
SEED = 7
RESIDUAL_MAX = 1e-12


def run(A, b):
    """(sym, num, x, row): host KLU of A and its solve of b, ``row`` the
    times in seconds, the residual and the factor's flops."""
    from ..cholesky import residual_norm
    from ..lu import klu_analyze, klu_factor, klu_refactor, klu_solve
    from ..utils.native import has_native
    if not has_native():
        raise RuntimeError("the native KLU kernel (native/libsstpu.so) "
                           "is not available")
    times = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        times[key] = time.perf_counter() - t0
        return out

    sym = timed("klu_analyze_s", lambda: klu_analyze(A))
    num = timed("klu_factor_s", lambda: klu_factor(A, sym))
    num = timed("klu_refactor_s", lambda: klu_refactor(A, sym, num))
    x = timed("klu_solve_s", lambda: klu_solve(num, b))
    res = residual_norm(A, x, b)
    if not (num.ok and res <= RESIDUAL_MAX):
        raise RuntimeError(f"host KLU: ok {num.ok}, residual {res:.3e} > "
                           f"{RESIDUAL_MAX}")
    sizes = np.diff(sym.r)
    row = dict(n=A.ncol, nnz=int(A.nnz), blocks=int(sym.nblocks),
               largest_block=int(sizes.max()), native=True,
               flops=float(num.flops), **times, residual=res)
    return sym, num, x, row


def main(n: int = N_DEFAULT) -> dict:
    from ..io.generators import circuit_like
    A = circuit_like(n)
    b = np.random.default_rng(SEED).standard_normal(n)
    row = dict(matrix=f"circuit_{n}", **run(A, b)[3])
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else N_DEFAULT)
