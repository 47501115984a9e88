"""Block-cyclic distributed dense Cholesky over torch.distributed ranks.

Counterpart of suitesparse_tpu/parallel/block_cyclic.py: the column-block-
cyclic right-looking Cholesky (the ScaLAPACK pdpotrf shape) of one dense
SPD front, written with explicit collectives.

Layout: the N x N front is padded to K = ceil(N/nb) column blocks of
width nb (K rounded up to a multiple of P); block j lives on rank j mod P,
and each rank stores its blocks contiguously as (Kloc, N, nb).  Step k:
  1. the owner broadcasts column panel k (its rows >= k*nb; the rows above
     are zero in the reference's masked psum);
  2. every rank factors the nb x nb diagonal block and applies the TRSM to
     the panel (duplicated: cheaper than a second broadcast);
  3. each rank updates only its own trailing blocks.
That step is ``cyclic_potrf``, which parallel.dist's fan-out of the large
top fronts and the root runs too.
One all-gather at the end gives every rank the whole factor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cholesky.super_numeric import cholesky_or_nan
from ..utils.device import torch_dtype


def _cyclic_order(K: int, ndev: int) -> np.ndarray:
    """Block ids in storage order: rank-major, cyclic within a rank
    (rank d stores blocks d, d+P, d+2P, ...)."""
    return np.array(sorted(range(K), key=lambda j: (j % ndev, j // ndev)),
                    dtype=np.int64)


def cyclic_potrf(K: int, nb: int, rows: int, like: torch.Tensor, mesh,
                 phase: str, panel, store, update) -> None:
    """The column-block-cyclic right-looking POTRF loop, shared by
    block_cyclic_cholesky and the fan-out of parallel.dist, whatever the
    layout of the caller's blocks.  Block column k lives on rank
    k % ndev.  Step k: the owner's rows >= k*nb of block column k
    (``panel(k)``, (rows - k*nb, nb)) are broadcast; every rank factors
    the diagonal block (``cholesky_or_nan``: NaN, never an exception, when
    it is not positive definite) and applies the TRSM below it; the owner
    keeps them (``store(k, Lkk, Bk)``); each rank updates its own block
    columns j > k (``update(j, k, Bk)``, Bk being rows >= (k+1)*nb)."""
    ndev, d = mesh.ndev, mesh.rank
    for k in range(K):
        owner = k % ndev
        p = (panel(k) if owner == d
             else like.new_empty((rows - k * nb, nb)))
        mesh.broadcast(p, owner, phase)
        Lkk = cholesky_or_nan(p[:nb][None])[0]
        Bk = torch.linalg.solve_triangular(Lkk.T, p[nb:], upper=True,
                                           left=False)
        if owner == d:
            store(k, Lkk, Bk)
        for j in range(d, K, ndev):
            if j > k:
                update(j, k, Bk)


def block_cyclic_cholesky(F: np.ndarray, mesh, nb: int = 128,
                          dtype=None) -> np.ndarray:
    """L = chol(F) (lower) with F symmetric positive definite, computed
    column-block-cyclically over the ranks of ``mesh`` (a
    ``parallel.dist.Mesh``), in ``dtype`` (F's by default) on the mesh's
    device.  A collective: every rank calls it with the same F, and every
    rank gets the dense lower factor back on the host."""
    ndev, d = mesh.ndev, mesh.rank
    dt = torch_dtype(F.dtype if dtype is None else dtype)
    N = F.shape[0]
    K = max(1, -(-N // nb))
    K = -(-K // ndev) * ndev          # pad #blocks to a multiple of P
    Npad = K * nb
    Ff = np.zeros((Npad, Npad), dtype=F.dtype)
    Ff[:N, :N] = F
    idx = np.arange(N, Npad)
    Ff[idx, idx] = 1.0                # padding = identity (stays finite)

    order = _cyclic_order(K, ndev)    # storage position -> global block id
    Kloc = K // ndev
    gloc = order[d * Kloc:(d + 1) * Kloc]          # d, d+P, d+2P, ...
    Floc = torch.as_tensor(
        np.ascontiguousarray(Ff.reshape(Npad, K, nb).transpose(1, 0, 2)[gloc]),
        dtype=dt, device=mesh.device)               # (Kloc, Npad, nb)

    def store(k, Lkk, Bk):
        kb = k * nb
        Floc[k // ndev, kb:kb + nb] = Lkk
        Floc[k // ndev, kb + nb:] = Bk

    def update(j, k, Bk):
        # rows >= j*nb only: the rows above are the upper triangle, which
        # the factor drops
        jb, r0 = j * nb, (k + 1) * nb
        Floc[j // ndev, jb:] -= Bk[jb - r0:] @ Bk[jb - r0:jb - r0 + nb].T

    cyclic_potrf(K, nb, Npad, Floc, mesh, "block_cyclic",
                 lambda k: Floc[k // ndev, k * nb:].clone(), store, update)
    out = torch.cat(mesh.all_gather(Floc, "block_cyclic")).cpu().numpy()
    Lf = np.empty((Npad, Npad), dtype=out.dtype)
    for pos, g in enumerate(order.tolist()):
        Lf[:, g * nb:(g + 1) * nb] = out[pos]
    return np.tril(Lf[:N, :N])
