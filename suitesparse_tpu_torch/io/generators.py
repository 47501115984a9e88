"""Synthetic test/benchmark matrix generators.

Offline stand-ins for the ssget benchmark families named in BASELINE.md
(bcsstk*, nd6k/nd24k, audikw_1, west0479, torso3, KLU circuit matrices).
Grid Laplacians are the canonical SPD model problems with the same
structure class (2D/3D FEM-like) as the bcsstk/nd/audikw sets; circuit
stand-ins use randomized modified-nodal-analysis-style patterns.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..core.sparse import SYM_UPPER, SparseCSC


def laplacian_2d(nx: int, ny: Optional[int] = None, dtype=np.float64) -> SparseCSC:
    """5-point 2D grid Laplacian, SPD (shifted by identity)."""
    ny = ny or nx
    Ix, Iy = sp.identity(nx), sp.identity(ny)
    Tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    A = sp.kron(Iy, Tx) + sp.kron(Ty, Ix) + 0.01 * sp.identity(nx * ny)
    return SparseCSC.from_scipy(sp.csc_matrix(A, dtype=dtype))


def laplacian_3d(nx: int, ny: Optional[int] = None, nz: Optional[int] = None,
                 dtype=np.float64) -> SparseCSC:
    """7-point 3D grid Laplacian, SPD."""
    ny, nz = ny or nx, nz or nx
    def T(n):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    Ix, Iy, Iz = sp.identity(nx), sp.identity(ny), sp.identity(nz)
    A = (sp.kron(Iz, sp.kron(Iy, T(nx)))
         + sp.kron(Iz, sp.kron(T(ny), Ix))
         + sp.kron(T(nz), sp.kron(Iy, Ix))
         + 0.01 * sp.identity(nx * ny * nz))
    return SparseCSC.from_scipy(sp.csc_matrix(A, dtype=dtype))


def random_spd(n: int, density: float = 0.01, seed: int = 0,
               dtype=np.float64) -> SparseCSC:
    """Random SPD: A = B B' + n I with sparse B."""
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=density, random_state=rng, format="csc")
    A = (B @ B.T + n * sp.identity(n)).tocsc()
    return SparseCSC.from_scipy(sp.csc_matrix(A, dtype=dtype))


def random_unsym(n: int, density: float = 0.01, seed: int = 0,
                 diag_dominant: bool = True, dtype=np.float64) -> SparseCSC:
    """Random unsymmetric square matrix with guaranteed nonzero diagonal."""
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=density, random_state=rng, format="csc")
    B = B + sp.diags(rng.uniform(1.0, 2.0, n) * (n * density + 1 if diag_dominant else 1))
    return SparseCSC.from_scipy(sp.csc_matrix(B, dtype=dtype))


def circuit_like(n: int, seed: int = 0, dtype=np.float64) -> SparseCSC:
    """Sparse unsymmetric circuit-sim-like matrix: near-symmetric pattern,
    strong diagonal, a few dense-ish rows/cols (voltage sources / rails) —
    the structure class KLU targets."""
    rng = np.random.default_rng(seed)
    k = max(1, n // 50)
    # sparse near-symmetric background
    B = sp.random(n, n, density=min(4.0 / n, 0.5), random_state=rng, format="coo")
    Bs = B + B.T.multiply(0.9)
    # rails: a few rows+cols with many entries
    rails = rng.choice(n, size=k, replace=False)
    rr, cc = [], []
    for r in rails:
        tie = rng.choice(n, size=max(2, n // 20), replace=False)
        rr.extend([r] * len(tie)); cc.extend(tie.tolist())
        rr.extend(tie.tolist()); cc.extend([r] * len(tie))
    rails_m = sp.coo_matrix((rng.standard_normal(len(rr)) * 0.1, (rr, cc)), shape=(n, n))
    A = (Bs + rails_m).tocsc()
    A = A + sp.diags(np.abs(A).sum(axis=1).A1 + 1.0)
    return SparseCSC.from_scipy(sp.csc_matrix(A, dtype=dtype))


def fem3d(n: int, seed: int = 0, dtype=np.float64) -> SparseCSC:
    """Unstructured 3-D FEM-class SPD matrix: graph Laplacian (+shift) of
    the Delaunay tetrahedralization of ``n`` seeded random points.

    Unlike the lap3d grids, the pattern is genuinely IRREGULAR: vertex
    degrees vary (~4-40), separators are uneven, and supernode shape
    buckets come out non-uniform — the structure class of the ssget
    nd6k/nd24k protocol matrices (CHOLMOD/Demo/gpu.sh:2-3) that the
    regular grids cannot stand in for.  Deterministic per (n, seed)."""
    from scipy.spatial import Delaunay
    rng = np.random.default_rng(seed)
    # clustered point density (uniform + two gaussian blobs) makes the
    # element size — and hence the elimination-tree shape — non-uniform
    n_u = n - n // 3 - n // 5
    pts = np.concatenate([
        rng.random((n_u, 3)),
        rng.normal([0.25, 0.25, 0.25], 0.06, (n // 3, 3)),
        rng.normal([0.7, 0.6, 0.5], 0.1, (n // 5, 3)),
    ])
    tet = Delaunay(pts)
    # edges of every tetrahedron
    s = tet.simplices
    pairs = np.concatenate([s[:, [a, b]] for a in range(4)
                            for b in range(a + 1, 4)])
    i = np.minimum(pairs[:, 0], pairs[:, 1])
    j = np.maximum(pairs[:, 0], pairs[:, 1])
    ij = np.unique(i.astype(np.int64) * len(pts) + j)
    i, j = ij // len(pts), ij % len(pts)
    keep = i != j
    i, j = i[keep], j[keep]
    w = np.ones(len(i))
    G = sp.coo_matrix((w, (i, j)), shape=(len(pts), len(pts)))
    G = G + G.T
    deg = np.asarray(G.sum(axis=1)).ravel()
    A = (sp.diags(deg + 0.05) - G).tocsc()
    return SparseCSC.from_scipy(sp.csc_matrix(A, dtype=dtype))


def cd3d(m: int, p: float = 0.5) -> SparseCSC:
    """The 7-point first-order upwind convection-diffusion operator on the
    m^3 grid: the Kronecker sum of tridiag(-(1+p), 2+p, -1) along each
    axis (cell Peclet number p) -- a symmetric pattern with unsymmetric
    values, n = m^3."""
    T = sp.diags([np.full(m - 1, -(1.0 + p)), np.full(m, 2.0 + p),
                  np.full(m - 1, -1.0)], [-1, 0, 1])
    eye = sp.identity(m)
    A = (sp.kron(sp.kron(T, eye), eye) + sp.kron(sp.kron(eye, T), eye)
         + sp.kron(sp.kron(eye, eye), T))
    return SparseCSC.from_scipy(sp.csc_matrix(A))


def grad3d(k: int) -> sp.csc_matrix:
    """The forward-difference gradient of the k^3 grid: the Kronecker sum
    of (k-1) x k difference matrices, 3 (k-1) k^2 x k^3, rank k^3 - 1 (the
    constants span its null space).  A SciPy matrix."""
    D = sp.diags([-np.ones(k - 1), np.ones(k - 1)], [0, 1], shape=(k - 1, k))
    eye = sp.identity(k)
    return sp.vstack([sp.kron(sp.kron(D, eye), eye),
                      sp.kron(sp.kron(eye, D), eye),
                      sp.kron(sp.kron(eye, eye), D)]).tocsc()


def grad3d_tik(k: int, mu: float = 2.0) -> SparseCSC:
    """Tikhonov-damped gradient [G; mu I]: full column rank, sigma_min =
    mu, sigma_max = sqrt(12 + mu^2)."""
    G = grad3d(k)
    return SparseCSC.from_scipy(sp.vstack(
        [G, mu * sp.identity(G.shape[1])]).tocsc())


def ring_chords(n: int, seed: int) -> SparseCSC:
    """Ring + 3n random chords: connected, ~4 edges a vertex (the JAX
    package's at-scale algorithm tests)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 3 * n)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, 3 * n)])
    keep = src != dst
    S = sp.csc_matrix((np.ones(keep.sum()), (src[keep], dst[keep])),
                      shape=(n, n))
    S.sum_duplicates()
    S.data[:] = 1.0
    return SparseCSC.from_scipy(S)


def symmetrize_upper(A: SparseCSC) -> SparseCSC:
    """Return upper-triangular symmetric storage of (A+A')/2 + shift."""
    S = A.to_scipy()
    S = (S + S.T) * 0.5
    U = sp.triu(S).tocsc()
    return SparseCSC(U.indptr, U.indices, U.data, U.shape, stype=SYM_UPPER)


# Honest synthetic names only.  These are parametric generator names — a
# synthetic matrix is NEVER served under a real collection matrix's name
# (a real name either resolves to a genuine file via io.fixtures /
# the cache, or raises).  Size classes comparable to the BASELINE families
# are noted for benchmark configuration:
#   lap3d_28  ~ nd6k scale   (n=21952, fl ~ 3.7e9)
#   lap3d_44  ~ nd24k scale  (n=85184, fl ~ 6e10)
#   lap3d_64  ~ audikw scale (n=262144)
_STANDINS = {
    "lap2d": laplacian_2d,
    "lap3d": laplacian_3d,
    "fem3d": fem3d,
    "randspd": lambda n: random_spd(n, density=min(0.02, 40.0 / n)),
    "randunsym": lambda n: random_unsym(n, density=min(0.02, 40.0 / n)),
    "circuit": circuit_like,
}


def synthetic_standin(name: str) -> Optional[SparseCSC]:
    """Parse parametric synthetic names: 'lap3d_28', 'circuit_3000', …"""
    if "_" not in name:
        return None
    fam, _, arg = name.rpartition("_")
    fn = _STANDINS.get(fam)
    if fn is None or not arg.isdigit():
        return None
    return fn(int(arg))
