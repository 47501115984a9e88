"""CSparse demo (CSparse/Demo/cs_demo2.c + cs_demo.out protocol) on the
port: dmperm stats and the one-call solvers cs_lusol / cs_cholsol /
cs_qrsol with the reference's residual (cs_demo.c:52-60).  The
counterpart of demos/cs_demo.py: cs_qrsol and cs_cholsol run on ``device``
(the card unless "cpu" is asked for; raises without one); dmperm and
cs_lusol (KLU) run on the host."""
import argparse

import numpy as np


def _resid(A, x, b):
    S = A.to_scipy()
    num = np.abs(S @ x - b).max()
    den = np.abs(S).sum(axis=1).max() * np.abs(x).max() + np.abs(b).max()
    return float(num / den)


def main(device=None):
    from ..io.fixtures import load
    from ..models import csparse as cs

    A = load("west0067", dtype=np.float64)   # genuine fixture
    n = A.ncol
    d = cs.cs_dmperm(A)
    print(f"cs_demo: n {n} nnz {A.nnz} blocks {len(d.r) - 1} "
          f"structural_rank {d.structural_rank}")
    b = np.arange(1, n + 1, dtype=np.float64) / n
    x = cs.cs_lusol(A, b, order=2)
    print(f"lusol   resid {_resid(A, x, b):.1e}")
    x = cs.cs_qrsol(A, b, order=3, device=device)
    print(f"qrsol   resid {_resid(A, x, b):.1e}")
    S = load("bcsstk01", dtype=np.float64)
    bs = np.ones(S.ncol)
    xs = cs.cs_cholsol(S, bs, order=1, device=device)
    print(f"cholsol resid {_resid(S, xs, bs):.1e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
