"""CHOLMOD demo (CHOLMOD/Demo/cholmod_demo.c protocol) on the port:
analyze / factorize / solve one SPD matrix; print ordering quality (fl/lnz,
lnz/anz, cholmod_demo.c:568-573) and the componentwise residual
||Ax-b||inf / (||A||1 ||x||inf + ||b||inf) for several solve systems
(:453-503, 598-611).  The counterpart of demos/cholmod_demo.py, in
float64.  Host only: the simplicial factor and its solves take no device."""
import sys

import numpy as np


def main(name="bcsstk01"):
    from ..cholesky import (analyze, factorize_simplicial, residual_norm,
                            solve)
    from ..core.common import default_common
    from ..io.fixtures import load

    A = load(name, dtype=np.float64)     # genuine reference fixture
    n = A.ncol
    cm = default_common()
    sym = analyze(A, cm)
    anz = A.nnz
    print(f"cholmod_demo: n {n} nnz(A) {anz}")
    print(f"ordering: lnz {sym.lnz} fl {sym.flops:.4e}")
    print(f"ordering quality: fl/lnz {sym.flops / sym.lnz:.2f} "
          f"lnz/anz {sym.lnz / anz:.2f}")
    f = factorize_simplicial(A, sym, cm)
    print(f"factor ok: {f.ok} minor {f.minor}")
    b = np.arange(1, n + 1, dtype=np.float64) / n
    for system in ["A", "LDLt", "L", "Lt", "D", "P", "Pt"]:
        x = solve(f, b, system)
        if system == "A":
            print(f"solve {system}: residual {residual_norm(A, x, b):.1e}")
        else:
            print(f"solve {system}: |x|inf {np.abs(x).max():.6e}")
    print(f"logdet {f.logdet():.6e}")


if __name__ == "__main__":
    main(*sys.argv[1:])
