"""KLU demo (KLU/Demo/kludemo.c + kludemo.out protocol) on the port: BTF
stats, factor/refactor/solve residuals and diagnostics per matrix.  The
counterpart of demos/klu_demo.py, in float64.  Host only: host KLU takes
no device."""
import sys

import numpy as np


def main():
    from ..core.sparse import SparseCSC
    from ..io.fixtures import load
    from ..lu import (klu_analyze, klu_factor, klu_rcond, klu_refactor,
                      klu_rgrowth, klu_solve)

    # genuine matrices from the reference's own KLU/Matrix demo set
    for name in ("impcol_a", "west0067"):
        A = load(name, dtype=np.float64)
        n = A.ncol
        sym = klu_analyze(A)
        print(f"{name}: n {n} nnz {A.nnz} nblocks {sym.nblocks} "
              f"nmatch {sym.nmatch}")
        num = klu_factor(A, sym)
        b = np.ones(n)
        x = klu_solve(num, b)
        r = np.abs(A.to_scipy() @ x - b).max()
        print(f"  factor ok {num.ok}; |Ax-b|inf {r:.1e}")
        A2 = SparseCSC(A.indptr, A.indices, A.data * 2.0, A.shape)
        num = klu_refactor(A2, sym, num)
        x = klu_solve(num, b)
        r = np.abs(A2.to_scipy() @ x - b).max()
        print(f"  refactor(2A): |Ax-b|inf {r:.1e}")
        print(f"  rcond {klu_rcond(num):.3e} rgrowth "
              f"{klu_rgrowth(A2, num):.3e}")


if __name__ == "__main__":
    main(*sys.argv[1:])
