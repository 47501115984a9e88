"""Device twin of the KLU refactor/solve hot path, in PyTorch.

Counterpart of suitesparse_tpu/lu/klu_device.py.  The reference's
circuit-simulation workflow (klu_refactor.c:7-18) is: analyze+factor ONCE,
then refactorize with the same pattern and pivot order for every Newton
step / Monte-Carlo sample.  A fixed pattern and pivot sequence means a
fixed program:

  host (once per pattern):  klu_analyze + klu_factor pick the BTF block
      structure, the per-block fill ordering, and the pivot rows; this
      module then precomputes STATIC index maps (entry -> dense block slot,
      off-diagonal entry -> (row,col) positions, block level schedule) --
      the reference's plan, copied.
  device (per value set):   assemble the scaled blocks, run a batched
      no-pivot dense LU per block-size group (the pivot order is baked
      into the row permutation), and solve by BTF block level sets with
      off-diagonal gaxpy between levels (klu_solve.c:207-219).

Blocks of equal size are stacked and factorized together; a leading
batch dimension over value sets (Monte-Carlo sweeps) sits on top, where
the reference vmaps.  Every sum over repeated rows (the row scaling, the
off-diagonal gaxpy) is a sorted segment sum over a host-precomputed sort
onto unique rows -- no atomics, so repeated calls are bit-identical on the
card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cholesky.super_numeric import _index, _seg_lengths, segment_sum
from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, invert_permutation
from ..core.status import SparseError, Status
from ..utils.device import default_dtype, resolve_device, torch_dtype
from ..utils.programs import DeviceProgram, cached_program
from .klu import KLUNumeric, KLUSymbolic


@dataclasses.dataclass
class _SizeGroup:
    nb: int                 # block size
    blocks: np.ndarray      # block ids, in increasing id order
    lo: np.ndarray          # block start offsets (len = len(blocks))
    src: np.ndarray         # A-entry indices landing in these blocks
    dst: np.ndarray         # flat destinations into (G, nb, nb)


@dataclasses.dataclass
class KLUDevicePlan:
    """Static maps for the device refactor/solve programs."""
    n: int
    nblocks: int
    scale: str
    rows: np.ndarray            # A.indices (for the row-scaling segment max)
    groups: list                # list[_SizeGroup]
    # off-diagonal entries (block-upper-triangular part):
    off_src: np.ndarray         # A-entry index
    off_i: np.ndarray           # global row position (final pivot order)
    off_j: np.ndarray           # global col position
    off_level: np.ndarray      # solve level of the entry's column block
    levels: list                # levels[l] = [(group_idx, member_mask)] rows
    block_level: np.ndarray
    p_final: np.ndarray
    q: np.ndarray
    r: np.ndarray
    _cache: dict = dataclasses.field(default_factory=dict)  # per device


def klu_device_plan(A: SparseCSC, sym: KLUSymbolic, num: KLUNumeric,
                    common: Optional[Common] = None) -> KLUDevicePlan:
    """Precompute the static maps (host, once per pattern)."""
    cm = common or default_common()
    n = sym.n
    if A.nrow != n or A.ncol != n:
        raise SparseError(Status.INVALID, "pattern mismatch")
    scale = cm.lu.scale if cm.lu.scale != "auto" else "max"
    r = np.asarray(sym.r, dtype=INDEX)
    nblocks = sym.nblocks
    pinv_final = invert_permutation(num.p_final)
    qinv = invert_permutation(sym.q)

    # classify every A entry: (col-major walk of the CSC arrays)
    cols = np.repeat(np.arange(n, dtype=INDEX), np.diff(A.indptr))
    ipos = pinv_final[A.indices]
    jpos = qinv[cols]
    block_of = np.searchsorted(r, np.arange(n), side="right") - 1
    bi, bj = block_of[ipos], block_of[jpos]
    if np.any(bi > bj):
        raise SparseError(Status.INVALID,
                          "entries below the BTF block diagonal")
    diag = bi == bj

    # size groups over the diagonal blocks
    sizes = np.diff(r)
    groups: list[_SizeGroup] = []
    group_of_block = np.empty(nblocks, dtype=INDEX)
    member_of_block = np.empty(nblocks, dtype=INDEX)
    for g, nb in enumerate(np.unique(sizes)):
        blocks = np.where(sizes == nb)[0]
        group_of_block[blocks] = g
        member_of_block[blocks] = np.arange(len(blocks))
        groups.append(_SizeGroup(nb=int(nb), blocks=blocks,
                                 lo=r[blocks], src=None, dst=None))
    ent_g = group_of_block[bi]
    for g, grp in enumerate(groups):
        sel = np.where(diag & (ent_g == g))[0]
        nb = grp.nb
        mem = member_of_block[bi[sel]]
        li = ipos[sel] - r[bi[sel]]
        lj = jpos[sel] - r[bi[sel]]
        grp.src = sel.astype(INDEX)
        grp.dst = (mem * nb * nb + li * nb + lj).astype(INDEX)

    # block solve levels: backward over blocks; block b must wait for every
    # block b' that feeds it through an off-diagonal entry (rows of b,
    # cols of b').  level 0 = no dependencies (solved first).
    off = np.where(~diag)[0]
    block_level = np.zeros(nblocks, dtype=INDEX)
    if len(off):
        import scipy.sparse as sp
        dep = sp.coo_matrix((np.ones(len(off)), (bi[off], bj[off])),
                            shape=(nblocks, nblocks)).tocsr()
        for b in range(nblocks - 1, -1, -1):
            cols_b = dep.indices[dep.indptr[b]:dep.indptr[b + 1]]
            if len(cols_b):
                block_level[b] = block_level[cols_b].max() + 1

    nlev = int(block_level.max()) + 1 if nblocks else 0
    levels = []
    for lev in range(nlev):
        per_group = []
        for g, grp in enumerate(groups):
            mask = block_level[grp.blocks] == lev
            if mask.any():
                per_group.append((g, np.where(mask)[0].astype(INDEX)))
        levels.append(per_group)

    return KLUDevicePlan(
        n=n, nblocks=nblocks, scale=scale,
        rows=A.indices.astype(INDEX), groups=groups,
        off_src=off.astype(INDEX), off_i=ipos[off].astype(INDEX),
        off_j=jpos[off].astype(INDEX),
        off_level=block_level[bj[off]].astype(INDEX),
        levels=levels, block_level=block_level,
        p_final=num.p_final.astype(INDEX), q=sym.q.astype(INDEX), r=r)



def _plan_tensors(plan: KLUDevicePlan, dev: torch.device) -> dict:
    """Device copies of the plan's maps, cached on the plan per device:
    the row sort of the scaling's segment sum, each group's assembly map,
    and per solve level the rows of each block group and the off-diagonal
    gaxpy sorted onto unique rows."""
    got = plan._cache.get(dev)
    if got is not None:
        return got
    order = np.argsort(plan.rows, kind="stable")
    levels = []
    for lev, per_group in enumerate(plan.levels):
        blocks = []
        for g, members in per_group:
            grp = plan.groups[g]
            rows = (grp.lo[members][:, None] + np.arange(grp.nb)).reshape(-1)
            blocks.append((g, _index(members, dev), _index(rows, dev)))
        sel = np.where(plan.off_level == lev)[0]
        off = None
        if len(sel):
            o = sel[np.argsort(plan.off_i[sel], kind="stable")]
            dst, ids = np.unique(plan.off_i[o], return_inverse=True)
            off = dict(src=_index(plan.off_src[o], dev),
                       j=_index(plan.off_j[o], dev), dst=_index(dst, dev),
                       lens=_seg_lengths(ids, len(dst), dev))
        levels.append((blocks, off))
    got = dict(
        rows=_index(plan.rows, dev), row_order=_index(order, dev),
        row_lens=_seg_lengths(plan.rows[order], plan.n, dev),
        groups=[(_index(g.src, dev), _index(g.dst, dev))
                for g in plan.groups],
        levels=levels, p_final=_index(plan.p_final, dev),
        q=_index(plan.q, dev))
    plan._cache[dev] = got
    return got


def _values(avals, dev: torch.device):
    """(S, nnz) value tensor on ``dev`` and whether the call was batched.
    A tensor keeps its dtype; host values take the device's default
    (float64/complex128 on the CPU, float32/complex64 on the card)."""
    if isinstance(avals, torch.Tensor):
        av = avals.to(dev)
    else:
        a = np.asarray(avals)
        av = torch.as_tensor(a, device=dev).to(torch_dtype(
            default_dtype(dev, np.iscomplexobj(a))))
    return (av, True) if av.ndim == 2 else (av[None], False)


def _scaled(plan: KLUDevicePlan, av, t):
    """Row-scale on the device: Rs = max/sum of |A| per row, for each of
    the S value sets of av (S, nnz).  The max is a scatter_reduce (its
    order does not matter); the sum is a sorted segment sum over the
    host-precomputed row sort."""
    S = av.shape[0]
    if plan.scale == "none":
        return av, av.new_ones((S, plan.n))
    mag = av.abs()
    if plan.scale == "max":
        Rs = mag.new_zeros((S, plan.n)).scatter_reduce(
            1, t["rows"].expand(S, -1), mag, "amax")
    else:  # sum
        Rs = segment_sum(mag[:, t["row_order"]].T, t["row_lens"]).T
    Rs = torch.where(Rs == 0, torch.ones_like(Rs), Rs).to(av.dtype)
    return av / Rs[:, t["rows"]], Rs


def _lu_nopivot(M):
    """Dense LU without pivoting of stacked blocks M (S, G, nb, nb), in
    place; the pivot order was fixed by the host factorization
    (klu_refactor semantics).  L (unit diagonal) is stored below the
    diagonal, U on and above.  A zero pivot is replaced by 1 and flagged
    per value set: returns (M, zero (S,)).

    Each step is the reference's full-matrix rank-1 form, so a non-finite
    multiplier spreads NaN exactly as there (0 * Inf)."""
    S, G, nb, _ = M.shape
    if nb == 1:
        zero = (M[:, :, 0, 0] == 0).any(dim=1)
        return torch.where(M == 0, torch.ones_like(M), M), zero
    zero = torch.zeros(S, dtype=torch.bool, device=M.device)
    idx = torch.arange(nb, device=M.device)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    nil = torch.zeros((), dtype=M.dtype, device=M.device)
    for k in range(nb):
        piv = M[:, :, k, k]
        isz = piv == 0
        zero |= isz.any(dim=1)
        safe = torch.where(isz, one, piv)         # klu-style continue
        below = idx > k
        l = torch.where(below, M[:, :, :, k] / safe[..., None], nil)
        u = torch.where(below, M[:, :, k, :], nil)
        M.addcmul_(l[..., :, None], u[..., None, :], value=-1)
        M[:, :, :, k] = torch.where(below, l, M[:, :, :, k])
        M[:, :, k, k] = safe
    return M, zero


def klu_refactor_program(plan: KLUDevicePlan, S: int, dtype,
                         device) -> DeviceProgram:
    """The device refactor of S value sets as one device program, cached
    on the plan per (S, dtype, device): av (S, nnz) -> (factors, Rs, ok),
    factors[g] of shape (S, G_g, nb_g, nb_g)."""
    dev = torch.device(device)

    def make():
        t = _plan_tensors(plan, dev)

        def body(av):
            sv, Rs = _scaled(plan, av, t)
            factors = []
            ok = torch.ones(S, dtype=torch.bool, device=av.device)
            for grp, (src, dst) in zip(plan.groups, t["groups"]):
                G, nb = len(grp.blocks), grp.nb
                M = sv.new_zeros((S, G * nb * nb))
                M[:, dst] = sv[:, src]
                F, zero = _lu_nopivot(M.view(S, G, nb, nb))
                ok &= ~zero
                factors.append(F)
            return factors, Rs, ok
        return body

    return cached_program(plan._cache, ("klu_refactor", int(S), dtype, dev),
                          make, dev)


def klu_solve_program(plan: KLUDevicePlan, S: int, k: int, dtype,
                      device) -> DeviceProgram:
    """The device solve of S value sets with k right-hand sides each as
    one device program, cached on the plan per (S, k, dtype, device):
    (Rs, av, X, *factors) -> x, X and x (S, n, k)."""
    dev = torch.device(device)

    def make():
        t = _plan_tensors(plan, dev)

        def body(Rs, av, X, *factors):
            sv, _ = _scaled(plan, av, t)
            X = (X / Rs[:, :, None])[:, t["p_final"]]
            for blocks, off in t["levels"]:
                for g, members, rows in blocks:
                    nb = plan.groups[g].nb
                    xb = X[:, rows].reshape(S, len(members), nb, -1)
                    F = factors[g][:, members]
                    if nb == 1:
                        xb = xb / F[..., 0][..., None]
                    else:
                        xb = torch.linalg.solve_triangular(
                            F, xb, upper=False, unitriangular=True)
                        xb = torch.linalg.solve_triangular(F, xb, upper=True)
                    X[:, rows] = xb.reshape(S, -1, X.shape[2])
                # off-diagonal contributions from columns solved in this
                # level
                if off is not None:
                    upd = sv[:, off["src"], None] * X[:, off["j"]]
                    X[:, off["dst"]] -= segment_sum(
                        upd.transpose(0, 1), off["lens"]).transpose(0, 1)
            out = torch.zeros_like(X)
            out[:, t["q"]] = X
            return out
        return body

    return cached_program(plan._cache, ("klu_solve", int(S), int(k), dtype,
                                        dev), make, dev)


def klu_refactor_jit(plan: KLUDevicePlan, device=None):
    """Return the device refactor: avals (nnz,) -> (factors, Rs, ok).

    factors[g] has shape (G_g, nb_g, nb_g) -- L\\U packed per size group.
    A Monte-Carlo sweep passes avals (S, nnz) and gets every output with
    a leading S axis (the reference's jax.vmap).  Each call runs
    ``klu_refactor_program`` for its S and dtype (the reference's
    ``jax.jit(klu_refactor_jit(plan))``): a replay on the card, the body
    on the CPU; its results are never shared with a later call's.  Runs on
    ``device`` (the card when None; raises without one)."""
    dev = resolve_device(device)

    def refactor(avals):
        av, batched = _values(avals, dev)
        prog = klu_refactor_program(plan, av.shape[0], av.dtype, dev)
        factors, Rs, ok = prog(av)
        if not batched:
            return [F[0] for F in factors], Rs[0], ok[0]
        return factors, Rs, ok

    return refactor


def klu_solve_jit(plan: KLUDevicePlan, device=None):
    """Return the device solve: (factors, Rs, avals, b) -> x with Ax=b.

    Runs the BTF block back-substitution by level sets: blocks in one level
    are independent; between levels the off-diagonal gaxpy is a static
    gather and a sorted segment sum onto unique rows (the
    klu_solve.c:207-219 loop, batched).  Unbatched b is (n,) or (n, k);
    with a sweep's (S, nnz) values, b is (n,) for every value set, or
    (S, n) or (S, n, k).  Each call runs ``klu_solve_program`` for its S,
    k and dtype."""
    dev = resolve_device(device)
    n = plan.n

    def solve(factors, Rs, avals, b):
        av, batched = _values(avals, dev)
        S = av.shape[0]
        bt = torch.as_tensor(b, device=dev)
        if not batched:
            factors = [F[None] for F in factors]
            Rs = Rs[None]
            bt = bt[None]
        elif bt.ndim == 1:
            bt = bt.expand(S, n)
        one_d = bt.ndim == 2
        X = bt.reshape(S, n, -1).to(av.dtype)
        prog = klu_solve_program(plan, S, X.shape[2], av.dtype, dev)
        out = prog(Rs, av, X, *factors)
        out = out.reshape(S, n) if one_d else out
        return out if batched else out[0]

    return solve


def klu_device(A: SparseCSC, sym: KLUSymbolic, num: KLUNumeric,
               common: Optional[Common] = None, device=None):
    """Convenience: plan + (refactor, solve) pair for the pattern, on
    ``device`` (the card when None; raises without one)."""
    dev = resolve_device(device)
    plan = klu_device_plan(A, sym, num, common)
    return plan, klu_refactor_jit(plan, dev), klu_solve_jit(plan, dev)
