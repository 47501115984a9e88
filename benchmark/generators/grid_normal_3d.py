"""The weighted normal matrix of minimum-Lp-norm phase unwrapping on an
nx x nx x nx grid (Ghiglia & Romero, JOSA A 13(10), 1996, extended to 3-D):
L = G^T G + mu^2 I, G the forward-difference gradient (one row per grid
edge (i, j), x_j - x_i), which is the Neumann graph Laplacian of the grid
plus mu^2 I.  Each value set the harness makes from it keeps the pattern
and turns L into G^T W G + mu^2 I for new edge weights W (the harness
scales each off-diagonal -1 by a weight and keeps each row's excess mu^2),
so a front end reads the least-squares matrix A = [W^1/2 G; mu I] of an
IRLS iteration back from L without loss."""
from __future__ import annotations

import scipy.sparse as sp


def make(nx: int, mu: float) -> sp.csc_matrix:
    D = sp.diags([-1.0, 1.0], [0, 1], shape=(nx - 1, nx))
    eye = sp.identity(nx)
    G = sp.vstack([sp.kron(sp.kron(D, eye), eye),
                   sp.kron(sp.kron(eye, D), eye),
                   sp.kron(sp.kron(eye, eye), D)])
    L = sp.csc_matrix(G.T @ G + float(mu) ** 2 * sp.identity(nx ** 3))
    L.sort_indices()
    return L
