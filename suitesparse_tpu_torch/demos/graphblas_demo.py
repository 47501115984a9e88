"""GraphBLAS demo (GraphBLAS/Demo: pagerank, BFS and triangle counting
over semirings) on the port.  The counterpart of demos/graphblas_demo.py:
every operation on ``device`` (the card unless "cpu" is asked for; raises
without one), in that device's default float type."""
import argparse

import numpy as np


def main(device=None):
    from ..core.sparse import SparseCSC
    from ..graphblas import (bfs_levels, mxm, pagerank, semiring,
                             triangle_count)
    from ..io.fixtures import load

    A = load("bcspwr10", dtype=np.float64)   # genuine fixture: power grid
    S = A.to_full_storage().to_scipy()
    S.setdiag(0)
    S.eliminate_zeros()
    S = abs(S.tocsc())
    G = SparseCSC.from_scipy((S > 0).astype(np.float64).tocsc())
    n = G.ncol
    pr = pagerank(G, device=device)
    print(f"graphblas_demo: n {n} nnz {G.nnz}")
    print(f"pagerank sum {np.sum(pr):.6f} max {np.max(pr):.6f}")
    lv = bfs_levels(G, 0, device=device)
    print(f"bfs levels from 0: max {int(lv.max())} "
          f"reached {int((lv >= 0).sum())}")
    print(f"triangles {triangle_count(G, device=device)}")
    C = mxm(G, G, semiring("plus_times"), device=device)
    print(f"G*G nnz {C.nnz}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
