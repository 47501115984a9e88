"""UMFPACK demo (UMFPACK/Demo/umfpack_*_demo.c protocol) on the port:
symbolic / numeric / solve with Info stats and the determinant.  The
counterpart of demos/umfpack_demo.py: the numeric factor on ``device`` (the
card unless "cpu" is asked for; raises without one), in float64, whose
determinant digits the output prints."""
import argparse

import numpy as np


def main(device=None):
    from ..core.common import default_common
    from ..io.fixtures import load
    from ..lu import (umf_determinant, umf_lunz, umf_numeric, umf_solve,
                      umf_symbolic)

    A = load("west0067", dtype=np.float64)   # genuine fixture
    n = A.ncol
    cm = default_common()
    sym = umf_symbolic(A, cm)
    print(f"umfpack_demo: n {n} nnz {A.nnz} strategy {sym.strategy}")
    num = umf_numeric(A, sym, cm, dtype=np.float64, device=device)
    lnz, unz = umf_lunz(num)[:2]
    print(f"numeric ok {num.ok}; lnz {lnz} unz {unz}")
    b = np.arange(1, n + 1, dtype=np.float64) / n
    x = umf_solve(num, b, "A", common=cm)
    r = np.abs(A.to_scipy() @ x - b).max()
    print(f"solve A: |Ax-b|inf {r:.1e} "
          f"iters {cm.info.get('umf_ir_taken', 0)}")
    xt = umf_solve(num, b, "At", common=cm)
    rt = np.abs(A.to_scipy().T @ xt - b).max()
    print(f"solve At: |A'x-b|inf {rt:.1e}")
    mant, expo = umf_determinant(num)
    print(f"determinant {mant:.6f} * 10^{expo:.0f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
