"""The 7-point first-order upwind convection-diffusion operator of an
nx x nx x nx grid (hypre's ``GenerateDifConv``, ``src/test/ij.c
-difconv``), scaled by h^2/c: the Kronecker sum of tridiag(-(1 + p),
2 + p, -1) along each axis, p the cell Peclet number |a| h / c with the
flow along +x, +y and +z (the port's ``chip_smoke.cd3d``, copied).  A
symmetric pattern with unsymmetric values; each row's diagonal equals the
sum of its off-diagonal magnitudes inside the grid and exceeds it on the
boundary, so the matrix is irreducibly diagonally dominant."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def make(nx: int, peclet: float) -> sp.csc_matrix:
    p = float(peclet)
    T = sp.diags([np.full(nx - 1, -(1.0 + p)), np.full(nx, 2.0 + p),
                  np.full(nx - 1, -1.0)], [-1, 0, 1])
    eye = sp.identity(nx)
    A = (sp.kron(sp.kron(T, eye), eye) + sp.kron(sp.kron(eye, T), eye)
         + sp.kron(sp.kron(eye, eye), T))
    A = sp.csc_matrix(A)
    A.sort_indices()
    return A
