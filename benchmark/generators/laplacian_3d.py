"""7-point Laplacian of an nx x ny x nz grid (PyAMG's gallery.poisson)
plus 0.01 I, a backward-Euler term (the port's
``io.generators.laplacian_3d``, copied): SPD, every row diagonally
dominant by at least 0.01."""
from __future__ import annotations

import scipy.sparse as sp


def make(nx: int, ny: int = 0, nz: int = 0) -> sp.csc_matrix:
    ny, nz = ny or nx, nz or nx

    def T(n):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))

    Ix, Iy, Iz = sp.identity(nx), sp.identity(ny), sp.identity(nz)
    A = (sp.kron(Iz, sp.kron(Iy, T(nx)))
         + sp.kron(Iz, sp.kron(T(ny), Ix))
         + sp.kron(T(nz), sp.kron(Iy, Ix))
         + 0.01 * sp.identity(nx * ny * nz))
    A = sp.csc_matrix(A)
    A.sort_indices()
    return A
