"""UMFPACK-class multifrontal LU in PyTorch (CPU or CUDA).

Counterpart of suitesparse_tpu/lu/multifrontal.py.  The host side --
strategy selection (umfpack_qsymbolic.c:1232-1247), the static row
matching, the BTF/singleton split and the symmetrized supernodal analysis
with its scatter maps -- is the reference's, copied, so the symbolic
objects (and the files they are saved in) are interchangeable with the
reference's.  The design is the reference's:

  1. rows are pivoted once on the host -- a maximum-transversal matching
     (+ scaling) puts large entries on the diagonal (unsymmetric
     strategy); the symmetric strategy keeps rows in place;
  2. the pattern of B = PAQ is symmetrized and the supernodal Cholesky
     machinery (partition, panels, level schedule, static extend-add
     maps) is reused with two flat buffers, L and U^T panels, which share
     the maps by pattern symmetry;
  3. each diagonal block pivots only within itself (batched LU with
     partial pivoting); the update C = L21 U12 is unchanged by
     block-local pivoting, so the static maps survive;
  4. iterative refinement at solve time recovers full accuracy
     (umf_solve.c:194-269), with native host KLU as the escape hatch.

The numeric and solve programs are plain PyTorch on an explicit device:
the front blocks go through torch.linalg's batched LU, whose LAPACK swap
list is turned into the reference's row permutation on the device; every
scatter goes through the plan's sorted/unique maps (a sorted segment sum
folds duplicates, the final scatter hits each target once), so no atomics
run and refactorizations are bit-identical on the card.  ``umf_program``
and ``umf_solve_program`` make them device programs, captured once per
pattern into CUDA graphs and replayed on the card (utils/programs.py); a
solve program reads the numeric that ``bind_umf_numeric`` copied in.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core.common import Common, default_common
from ..core.sparse import (INDEX, UNSYM, SparseCSC, SYM_UPPER,
                           invert_permutation)
from ..core.status import SparseError, Status
from ..graph import maxtrans
from ..cholesky.supernodal import SuperSymbolic, super_symbolic
from ..cholesky.symbolic import Symbolic, analyze
from ..cholesky.super_numeric import (NumericPlan, _index, _panels,
                                      _set_cols, _sub_rows, build_plan,
                                      segment_sum, sorted_scatter_maps)
from ..utils.device import (default_dtype, numpy_dtype, resolve_device,
                            torch_dtype)
from ..utils.programs import (Binding, DeviceProgram, PatternMap,
                              cached_program, pattern_map, program_device)
from ..utils.trace import moved, span, spanned


@dataclasses.dataclass
class UmfSingletons:
    """Singleton/BTF decomposition payload (umf_singletons analog,
    umfpack_qsymbolic.c:1081-1100, generalized to full BTF): PAQ is block
    upper triangular; 1x1 blocks are singleton pivots, each larger block
    carries its own inner UmfSymbolic."""

    p: np.ndarray               # BTF row perm
    q: np.ndarray               # BTF col perm
    r: np.ndarray               # block boundaries (nblocks+1)
    subs: list                  # per block: None (1x1) or (UmfSymbolic, Ablk)


@dataclasses.dataclass
class UmfSymbolic:
    """Reusable symbolic object (umfpack_*_symbolic analog)."""

    n: int
    strategy: str               # "symmetric" | "unsymmetric" | "btf"
    rowmatch: np.ndarray        # static row matching (row i of A -> position)
    sym: Symbolic               # fill ordering etc. of the symmetrized pattern
    ss: SuperSymbolic
    plan: NumericPlan
    a_scatter_L: np.ndarray     # flat dst for entries i >= j (L buffer)
    a_scatter_U: np.ndarray     # flat dst for entries i < j  (U^T buffer)
    a_perm_rows: np.ndarray     # final row perm: B = A[a_perm_rows, :][:, qcol]
    a_perm_cols: np.ndarray
    sym_ratio: float
    nzdiag: int
    singles: Optional[UmfSingletons] = None


def _max_product_matching(A: SparseCSC):
    """MC64-class maximum-product matching: a perfect matching maximizing
    prod |a_{match(j), j}|, via exact min-weight bipartite matching on
    -log(|a|/colmax) costs (Jonker-Volgenant).  The static-pivot analog of
    Duff-Koster MC64 job=4, the standard GESP pre-pivoting.  Returns the
    column->row match or None (structurally singular / unavailable)."""
    try:
        from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    except ImportError:                        # pragma: no cover
        return None
    import scipy.sparse as sp
    n = A.ncol
    absd = np.abs(A.data).astype(np.float64)
    col = np.repeat(np.arange(n, dtype=INDEX), np.diff(A.indptr))
    colmax = np.zeros(n)
    np.maximum.at(colmax, col, absd)
    colmax[colmax == 0] = 1.0
    w = -np.log(np.maximum(absd, 1e-300) / colmax[col]) + 1e-12
    Cw = sp.csc_matrix((w, A.indices, A.indptr), shape=A.shape)
    try:
        r, c = min_weight_full_bipartite_matching(Cw.tocsr())
    except Exception:
        return None
    if len(r) < n:
        return None
    match = np.empty(n, dtype=INDEX)
    match[c] = r
    return match


def _weighted_matching(A: SparseCSC) -> tuple[np.ndarray, int]:
    """MC64-flavored static pivot selection: a perfect matching using only
    *large* entries when one exists.

    The reference relies on dynamic threshold partial pivoting
    (umf_local_search.c); our static-pivot design needs large diagonal
    entries up front.  First choice is the exact maximum-product matching
    (above); the fallback runs structural maxtrans on progressively relaxed
    thresholded patterns (|a_ij| >= t * max|col j|) and keeps the strictest
    level that still yields a maximum matching.
    """
    if A.data is None:
        return maxtrans(A)
    m = _max_product_matching(A)
    if m is not None:
        return m, A.ncol
    n = A.ncol
    colmax = np.zeros(n)
    for j in range(n):
        lo, hi = int(A.indptr[j]), int(A.indptr[j + 1])
        if hi > lo:
            colmax[j] = np.abs(A.data[lo:hi]).max()
    col = np.repeat(np.arange(n, dtype=INDEX), np.diff(A.indptr))
    absval = np.abs(A.data)
    _, full_rank = maxtrans(A)
    best = None
    for t in (0.5, 0.1, 0.01, 0.001, 0.0):
        keep = absval >= t * colmax[col]
        if t == 0.0:
            keep[:] = True
        indptr = np.zeros(n + 1, dtype=INDEX)
        np.add.at(indptr, col[keep] + 1, 1)
        np.cumsum(indptr, out=indptr)
        sub = SparseCSC(indptr, A.indices[keep], None, A.shape)
        m, nm = maxtrans(sub)
        if nm == full_rank:
            best = (m, nm)
            break
        best = (m, nm)
    return best


@spanned("umf.symbolic")
def umf_symbolic(A: SparseCSC, common: Optional[Common] = None) -> UmfSymbolic:
    """Strategy selection + static row matching + symmetrized supernodal
    analysis (umfpack_qsymbolic equivalent).

    Spans (utils/trace): ``umf.symbolic`` around the call, with the
    ordering's and the plan builders' spans inside it and
    ``plan.umf_maps`` (the full-A scatter maps)."""
    cm = common or default_common()
    cm.checkpoint("umf_symbolic")
    n = A.ncol
    if A.nrow != n:
        raise SparseError(Status.INVALID, "umf LU needs a square matrix")
    from ..core.sparse import symmetry
    sym_ratio, nzdiag = symmetry(A)
    opts = cm.lu

    # -- singleton pruning (umf_singletons generalized to BTF blocks) ------
    if opts.singletons and n > 1:
        from ..graph.btf import btf_order
        bt = btf_order(A)
        nb = len(bt.r) - 1
        if nb > 1:
            import copy
            import scipy.sparse as sp
            Spq = A.to_scipy().tocsc()[bt.p][:, bt.q].tocsc()
            cm2 = copy.deepcopy(cm)
            cm2.lu.singletons = False
            cm2.disarm()
            subs = []
            for k in range(nb):
                r0, r1 = int(bt.r[k]), int(bt.r[k + 1])
                if r1 - r0 == 1:
                    subs.append(None)
                else:
                    Ablk = SparseCSC.from_scipy(
                        sp.csc_matrix(Spq[r0:r1, r0:r1]))
                    subs.append((umf_symbolic(Ablk, cm2), Ablk))
            cm.info["umf_btf_blocks"] = nb
            return UmfSymbolic(
                n=n, strategy="btf", rowmatch=None, sym=None, ss=None,
                plan=None, a_scatter_L=None, a_scatter_U=None,
                a_perm_rows=bt.p, a_perm_cols=bt.q,
                sym_ratio=sym_ratio, nzdiag=nzdiag,
                singles=UmfSingletons(p=bt.p, q=bt.q,
                                      r=np.asarray(bt.r, dtype=INDEX),
                                      subs=subs))
    if opts.strategy == "auto":
        strategy = ("symmetric"
                    if sym_ratio >= opts.sym_threshold
                    and nzdiag >= opts.nzdiag_threshold * n
                    else "unsymmetric")
    else:
        strategy = opts.strategy

    if strategy == "symmetric":
        rowmatch = np.arange(n, dtype=INDEX)
    else:
        match, nmatch = _weighted_matching(A)
        if nmatch < n:
            # structurally singular: complete arbitrarily (graceful; numeric
            # phase will flag SINGULAR)
            free = np.setdiff1d(np.arange(n, dtype=INDEX), match[match >= 0])
            k = 0
            for j in range(n):
                if match[j] < 0:
                    match[j] = free[k]
                    k += 1
        rowmatch = match          # column j's matched row
    # B = A with matched rows moved onto the diagonal: B[j, :] ... we permute
    # rows so row rowmatch[j] sits at position j
    rperm = rowmatch              # position j <- row rowmatch[j]
    B = A.permute(rperm, None)

    # symmetrized pattern for the fill analysis — STRUCTURAL, not
    # value-based: explicit stored zeros are entries (umfpack keeps them;
    # a value-based `!= 0` here would shrink the analysis pattern below
    # the scatter maps' pattern and collide slots — seen on west0479)
    import scipy.sparse as sp
    S = B.to_scipy()
    Spat = sp.csc_matrix(
        (np.ones(S.nnz), S.indices.copy(), S.indptr.copy()), shape=S.shape)
    Ssym = (Spat + Spat.T).astype(np.float64)
    U = sp.triu(Ssym).tocsc()
    Asym = SparseCSC(U.indptr.astype(INDEX), U.indices.astype(INDEX),
                     U.data, U.shape, stype=SYM_UPPER)
    cm.cholesky.supernodal = "supernodal"
    sym = analyze(Asym, cm)
    ss = super_symbolic(Asym, sym, cm)
    plan = build_plan(ss)

    # full-A scatter maps: B2 = B[perm, perm] entries (i, j):
    #   i >= j -> L buffer at s(j): off + local(i)*ns + (j - j1)
    #   i <  j -> U^T buffer at s(i): off + local(j)*ns + (i - j1)
    p = sym.perm
    with span("plan.umf_maps"):
        B2 = B.permute(p, p).sort_indices()
        cols = np.repeat(np.arange(n, dtype=INDEX), np.diff(B2.indptr))
        rows = B2.indices
        sup = ss.super.astype(np.int64)
        rowptr = ss.sn_rowptr.astype(np.int64)
        # (supernode, row) of every panel row, sorted: each supernode's
        # rows are sorted, so one search finds a row's local index
        keys = (np.repeat(np.arange(ss.nsuper, dtype=np.int64),
                          np.diff(rowptr)) * (n + 1) + ss.sn_rows)

        def _dst(rr, cc):
            # entry (row rr, col cc) -> padded-panel position in the
            # supernode of cc (SuperSymbolic.flat_pos, for every entry)
            s_of = ss.col_to_super[cc].astype(np.int64)
            loc = np.searchsorted(keys, s_of * (n + 1) + rr) - rowptr[s_of]
            ns = sup[s_of + 1] - sup[s_of]
            Np = ss.panel_Np[s_of].astype(np.int64)
            prow = np.where(loc < ns, loc, Np + (loc - ns))
            return (ss.panel_off[s_of] + prow * Np
                    + (cc - sup[s_of])).astype(INDEX)

        low = rows >= cols
        dstL = np.full(len(rows), -1, dtype=INDEX)
        dstU = np.full(len(rows), -1, dtype=INDEX)
        dstL[low] = _dst(rows[low], cols[low])
        up = ~low
        # U^T: entry (i, j), i<j stored at supernode of i, local index of j
        dstU[up] = _dst(cols[up], rows[up])

    return UmfSymbolic(n=n, strategy=strategy, rowmatch=rowmatch, sym=sym,
                       ss=ss, plan=plan, a_scatter_L=dstL, a_scatter_U=dstU,
                       a_perm_rows=rperm[p] if strategy != "symmetric" else p,
                       a_perm_cols=p, sym_ratio=sym_ratio, nzdiag=nzdiag)


# ---------------------------------------------------------------------------
# Numeric phase: LU level steps
# ---------------------------------------------------------------------------

def _block_lu(T: torch.Tensor):
    """Batched LU with partial pivoting of the (B, Np, Np) front blocks:
    (packed L\\U, perm) with T[b, perm[b]] = L U -- the permutation form
    of jax.lax.linalg.lu.  torch returns LAPACK's 1-based swap list; its
    permutation matrix P (T = P L U) is unpacked on the device and perm
    read off its columns."""
    lu, piv, _ = torch.linalg.lu_factor_ex(T)
    P = torch.lu_unpack(lu, piv, unpack_data=False)[0]
    return lu, P.real.argmax(dim=1)


def _lu_level_step(Lb, Ub, bucket_arrays, bucket_meta):
    """Factor one level: batched block-LU with restricted pivoting, written
    back into the panel views of both buffers in place.

    Extend-add uses the sorted-segment formulation of the Cholesky
    program: C scatters into the L buffer and C^T into the U^T buffer
    through the same sorted/unique maps.

    Returns the per-bucket pivot permutations."""
    pivs = []
    for ops, (Np, Mb, base, B) in zip(bucket_arrays, bucket_meta):
        Mp = Np + Mb
        PL = _panels(Lb, base, B, Mp, Np)
        PU = _panels(Ub, base, B, Mp, Np)
        # lower + diag of the front block, and the strictly-lower U^T part
        T = PL[:, :Np, :] + torch.tril(PU[:, :Np, :], -1).transpose(1, 2)
        T = T + torch.diag_embed(ops["padeye"])
        lu, perm = _block_lu(T)
        pivs.append(perm)
        if Mb:
            eye = torch.eye(Np, dtype=lu.dtype, device=lu.device)
            L11 = torch.tril(lu, -1) + eye
            U11 = torch.triu(lu)
            A21 = PL[:, Np:, :]                       # (B, Mb, Np)
            # permute A12's rows by the block pivots = A12^T's columns
            A12t = torch.gather(PU[:, Np:, :], 2,
                                perm[:, None, :].expand(B, Mb, Np))
            # L21 = A21 U11^{-1}
            L21 = torch.linalg.solve_triangular(U11, A21, upper=True,
                                                left=False)
            # U12 = L11^{-1} A12  =>  U12^T = A12^T L11^{-T}
            U12t = torch.linalg.solve_triangular(L11.transpose(1, 2), A12t,
                                                 upper=True, left=False)
            C = torch.bmm(L21, U12t.transpose(1, 2))      # (B, Mb, Mb)
            newL = torch.cat([lu, L21], dim=1)
            newU = torch.cat([torch.zeros_like(lu), U12t], dim=1)
        else:
            newL = lu
            newU = torch.zeros_like(lu)
        mask = ops["rowmask"][:, :, None] * ops["colmask"][:, None, :]
        PL.copy_(newL * mask)
        PU.copy_(newU * mask)
        dst = ops["dst"]
        if Mb and dst.shape[0]:
            # targets live in LATER (ancestor) buckets only, so updating
            # after this bucket's write is hazard-free.  C and C^T share
            # the maps, so one segment sum folds both, as two columns
            src = ops["src"]
            seg = segment_sum(torch.stack(
                (C.reshape(-1)[src], C.transpose(1, 2).reshape(-1)[src]),
                dim=1), ops["lens"])
            Lb[dst] -= seg[:, 0]
            Ub[dst] -= seg[:, 1]
    return pivs


def _lu_run_levels(Lb, Ub, level_arrays, meta):
    return tuple(tuple(_lu_level_step(Lb, Ub, level_arrays[li], meta[li]))
                 for li in range(len(meta)))


# torch.linalg's LU takes MAGMA for some batched front shapes on the card
# (e.g. 2 fronts of 512), and MAGMA's batched getrf cannot be captured in
# a CUDA graph; cuSOLVER's can, so the LU programs run with cuSOLVER
_LU_LIBRARY = "cusolver"


def umf_program(S: UmfSymbolic, dtype, device) -> DeviceProgram:
    """The numeric LU as one device program, cached on the symbolic's
    plan per (dtype, device) -- the reference's ``_lu_run_levels`` program
    (suitesparse_tpu/lu/multifrontal.py:334): the scaled, permuted values
    (nnz,) in, (Lb, Ub, pivs) out: the assembly writes, then the level
    loop."""
    dt = torch_dtype(dtype)
    dev = torch.device(device)

    def make():
        m = _device_maps(S, dev)
        arrays = S.plan.arrays_segsum(dt, dev)
        size = S.plan.total + 1

        def body(vj):
            # sorted+unique assembly sets
            # (cholesky.super_numeric.sorted_scatter_maps)
            Lb = vj.new_zeros(size)
            Ub = vj.new_zeros(size)
            Lb[m["dstL"]] = vj[m["srcL"]]
            Ub[m["dstU"]] = vj[m["srcU"]]
            pivs = _lu_run_levels(Lb, Ub, arrays, S.plan.meta)
            return Lb, Ub, pivs
        return body

    return cached_program(S.plan._cache, ("umf_numeric", dt, dev), make, dev,
                          library=_LU_LIBRARY)


@dataclasses.dataclass
class UmfNumeric:
    symbolic: UmfSymbolic
    Lb: torch.Tensor
    Ub: torch.Tensor
    pivs: tuple                  # per level, per bucket: (B, Np) permutations
    Rs: np.ndarray               # row scaling of original A
    dtype: object
    singular: bool
    # BTF/singleton payload: per-block inner numerics (None for 1x1) plus
    # the permuted matrix for singleton pivots and off-diagonal gaxpy
    bnums: Optional[list] = None
    bAs: Optional[list] = None   # per block: the current-value submatrix
    Spq_csc: object = None
    Spq_csr: object = None
    # matched-diagonal column scaling (GESP two-sided equilibration);
    # the factored matrix is diag(1/Rs)[rows] A [cols] diag(1/Cs)
    Cs: Optional[np.ndarray] = None

    @property
    def ok(self) -> bool:
        return not self.singular


def _device_maps(S: UmfSymbolic, dev: torch.device) -> dict:
    """Device copies of the assembly maps and of the flat positions of
    U's diagonal (the singular check), cached on the plan per device."""
    key = ("umf", dev)
    got = S.plan._cache.get(key)
    if got is None:
        with span("plan.umf_device_maps"):
            maps = S.plan._cache.get("umf_a_sorted")
            if maps is None:
                maps = S.plan._cache["umf_a_sorted"] = (
                    sorted_scatter_maps(S.a_scatter_L),
                    sorted_scatter_maps(S.a_scatter_U))
            (srcL, dstL), (srcU, dstU) = maps
            ss = S.ss
            diag = [int(ss.panel_off[s]) + np.arange(ss.panel_shape(s)[1])
                    * (int(ss.panel_Np[s]) + 1) for s in range(ss.nsuper)]
            got = dict(srcL=_index(srcL, dev), dstL=_index(dstL, dev),
                       srcU=_index(srcU, dev), dstU=_index(dstU, dev),
                       diag=_index(np.concatenate(diag), dev))
            S.plan._cache[key] = got
    return got


@dataclasses.dataclass(eq=False)
class _UmfScaleOrders:
    """The orders the scalings read A in, fixed by the pattern: the
    ``extra`` of the LU value map, whose ``vmap`` says where each value of
    the factored matrix B2 = (A scaled)[a_perm_rows, :][:, a_perm_cols],
    columns sorted, comes from in ``A.data``."""

    csr_order: np.ndarray       # A's entries row by row (_row_scale's CSR)
    nonempty: np.ndarray        # (nrow,) rows with an entry
    starts: np.ndarray          # their first entries in csr_order
    diag_pos: Optional[np.ndarray]  # (n,) B2's diagonal entries (-1: none)
    b2_col: Optional[np.ndarray]    # (nnz,) B2's column of each A entry


def _umf_value_map(S: UmfSymbolic, A: SparseCSC) -> PatternMap:
    """The value map of ``A``'s pattern under the symbolic ``S``, kept in
    ``S.plan._cache`` as a ``PatternMap`` (utils/programs) whose ``extra``
    is a ``_UmfScaleOrders``, reused while A has the pattern it was made
    from and rebuilt for another pattern or layout.

    Made (span ``plan.umf_value_map``) by running the values' chain --
    SciPy's CSR for the row sums, the row and column fancy-indexing, the
    column sort -- on the positions of A's entries, since each step only
    selects and reorders.  Raises SparseError(INVALID) when A's entry
    count is not the symbolic's."""
    def build():
        itype = np.int32 if A.nnz < 2**31 - 1 else np.int64
        # positions from 1: a position 0 would be a stored zero
        pos = SparseCSC(A.indptr, A.indices,
                        np.arange(1, A.nnz + 1, dtype=np.int64),
                        A.shape).to_scipy()
        csr = pos.tocsr()
        nonempty = np.diff(csr.indptr) > 0
        B2 = pos[S.a_perm_rows, :][:, S.a_perm_cols].tocsc()
        B2.sort_indices()
        if B2.nnz != len(S.a_scatter_L):
            raise SparseError(Status.INVALID,
                              "umf_numeric: the matrix's pattern is not the "
                              "symbolic's")
        vmap = (B2.data - 1).astype(itype)
        diag_pos = b2_col = None
        if S.strategy != "symmetric":
            diag_pos = (B2.diagonal() - 1).astype(itype)
            b2_col = np.empty(A.nnz, dtype=itype)
            b2_col[vmap] = np.repeat(np.arange(S.n, dtype=itype),
                                     np.diff(B2.indptr))
        return vmap, _UmfScaleOrders(
            csr_order=(csr.data - 1).astype(itype), nonempty=nonempty,
            starts=csr.indptr[:-1][nonempty], diag_pos=diag_pos,
            b2_col=b2_col)

    return pattern_map(S.plan._cache, "umf_value_map", A, build,
                       "plan.umf_value_map")


def _scaled_values(vo: _UmfScaleOrders, S: UmfSymbolic, data: np.ndarray,
                   indices: np.ndarray, scale: str, dtype):
    """(values, Rs, Cs): A's values scaled on both sides and cast to
    ``dtype``, in A's own order, with their row and column scalings.  Each
    float operation is the one the SciPy chain that the value map stands
    for makes on the same operands, so ``values[vmap]`` is that chain's B2
    bit for bit: the row sums are ``klu._row_scale``'s (umfpack default:
    sum scaling, umfpack.h), summed in its CSR order."""
    nrow = len(vo.nonempty)
    Rs = np.ones(nrow)
    if scale != "none" and len(data):
        red = np.maximum.reduceat if scale == "max" else np.add.reduceat
        Rs[vo.nonempty] = red(np.abs(np.take(data, vo.csr_order)),
                              vo.starts)
    Rs[Rs == 0.0] = 1.0
    # both scalings multiply the stored values in place, so every stored
    # entry -- explicit zeros included -- keeps its slot in the symbolic's
    # scatter maps (a sparse product would drop stored zeros)
    sc = data * np.take(1.0 / Rs, indices)
    # column scaling by the matched diagonal (GESP/MC64 duals analog):
    # makes every static pivot 1 after two-sided scaling, which keeps the
    # restricted-pivot factorization well-conditioned on hard matrices
    if S.strategy != "symmetric" and scale != "none":
        has = vo.diag_pos >= 0
        diag = np.zeros(S.n, dtype=sc.dtype)
        diag[has] = np.take(sc, vo.diag_pos[has])
        Cs = np.abs(diag)
        Cs[(Cs == 0) | ~np.isfinite(Cs)] = 1.0
        sc = sc * np.take(1.0 / Cs, vo.b2_col)
    else:
        Cs = np.ones(S.n)
    return sc.astype(dtype), Rs, Cs


@spanned("umf.numeric")
def umf_numeric(A: SparseCSC, S: UmfSymbolic,
                common: Optional[Common] = None, dtype=None,
                device=None) -> UmfNumeric:
    """umfpack_*_numeric: the LU of B = P R^{-1} A Q on ``device`` (the
    card when None; raises without one).  dtype: float64/complex128 on
    the CPU and float32/complex64 on the card unless given.

    Spans (utils/trace): ``umf.numeric`` around the call, and inside it
    ``.values`` (the row sums, the row and column scalings and the cast
    of the values on the host, in A's own order; cm.info
    ``time_umf_values``), with ``plan.umf_value_map`` inside the first
    one of a pattern (``_umf_value_map``: where each value of B2 comes
    from in A), ``.upload`` (h2d), ``.gather`` (the values put in B2's
    order on the device, d2d), ``.program`` (the LU program's copy-in,
    replay and clones, d2d) and ``.check`` (the NaN and pivot scan, which
    waits for the device).  The BTF path nests one ``umf.numeric`` a
    block.  The first call on a pattern warms up and captures the LU
    program inside ``.program`` (``umf_program(S, dtype, device)`` holds
    its ``warmup_s``, ``capture_s`` and ``nodes``)."""
    cm = common or default_common()
    cm.checkpoint("umf_numeric")
    dev = resolve_device(device)
    cm.tic("umf_numeric")
    if dtype is None:
        dtype = default_dtype(dev, A.data is not None
                              and np.iscomplexobj(A.data))
    dtype = numpy_dtype(dtype)
    n = S.n

    # -- BTF/singleton path: factor each block, keep PAQ for the solve ----
    if S.singles is not None:
        import scipy.sparse as sp
        sg = S.singles
        Spq = A.to_scipy().tocsc()[sg.p][:, sg.q].tocsc()
        bnums = []
        bAs = []
        singular = False
        tiny = np.finfo(np.float64).tiny
        for k, sub in enumerate(sg.subs):
            r0, r1 = int(sg.r[k]), int(sg.r[k + 1])
            if sub is None:
                piv = Spq[r0, r0]
                if abs(piv) < tiny:
                    singular = True
                bnums.append(None)
                bAs.append(None)
            else:
                ssym, _ = sub
                # refactorization: values come from the CURRENT matrix
                # (pattern fixed, umfpack numeric-reuse contract)
                Ablk = SparseCSC.from_scipy(sp.csc_matrix(Spq[r0:r1, r0:r1]))
                bn = umf_numeric(Ablk, ssym, cm, dtype=dtype, device=dev)
                singular |= bn.singular
                bnums.append(bn)
                bAs.append(Ablk)
        cm.status = Status.SINGULAR if singular else Status.OK
        t = cm.toc("umf_numeric")
        cm.info.update({"umf_numeric_time": t, "umf_strategy": "btf"})
        return UmfNumeric(symbolic=S, Lb=None, Ub=None, pivs=None,
                          Rs=np.ones(n), dtype=dtype, singular=singular,
                          bnums=bnums, bAs=bAs, Spq_csc=Spq,
                          Spq_csr=Spq.tocsr())
    # the host scales and casts the values in A's order (info
    # "time_umf_values"); the device puts them in B2's order
    with span("umf.numeric.values"):
        cm.tic("umf_values")
        if A.stype != UNSYM:
            # the full matrix, whose values the scalings read
            A = SparseCSC.from_scipy(A.to_scipy())
        vm = _umf_value_map(S, A)
        data = A.data if A.data is not None else np.ones(A.nnz)
        host, Rs, Cs = _scaled_values(vm.extra, S, data, A.indices,
                                      cm.lu.scale, dtype)
        cm.toc("umf_values")

    m = _device_maps(S, dev)
    with span("umf.numeric.upload"):
        va = torch.as_tensor(host, device=dev)
        moved("h2d", host.nbytes)
    with span("umf.numeric.gather"):
        vj = torch.index_select(va, 0, vm.device(dev))
        del va
        moved("d2d", host.nbytes)
    with span("umf.numeric.program"):
        Lb, Ub, pivs = umf_program(S, dtype, dev)(vj)
    # singular: a NaN/Inf anywhere, or a zero/denormal pivot on diag(U)
    # (umfpack's singular warning), read in float64 as the reference does
    with span("umf.numeric.check"):
        d = Lb[m["diag"]].abs().to(torch.float64)
        singular = bool(~torch.isfinite(Lb).all()
                        | (d < np.finfo(np.float64).tiny).any())
    t = cm.toc("umf_numeric")
    cm.status = Status.SINGULAR if singular else Status.OK
    cm.info.update({"umf_numeric_time": t, "umf_strategy": S.strategy})
    return UmfNumeric(symbolic=S, Lb=Lb, Ub=Ub, pivs=pivs, Rs=Rs,
                      dtype=dtype, singular=singular, Cs=Cs)


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------

def _gather_rows(xc, perm):
    """xc[b, perm[b], :] for a (B, Np, k) block of right-hand sides."""
    return torch.gather(xc, 1, perm[:, :, None].expand(-1, -1, xc.shape[2]))


def _conj(a, conj: bool):
    return a.conj() if conj else a


def _lu_lsolve_impl(Lb, x, pivs, level_arrays, meta):
    """Forward: y = L \\ (P_blk x) -- per-supernode block pivots applied,
    unit-lower solve, updates pushed into below rows (UMFPACK_L family)."""
    for li in range(len(meta)):
        for bi, (ops, (Np, Mb, base, B)) in enumerate(
                zip(level_arrays[li], meta[li])):
            PL = _panels(Lb, base, B, Np + Mb, Np)
            L11 = torch.tril(PL[:, :Np, :], -1) + torch.eye(
                Np, dtype=Lb.dtype, device=Lb.device)
            xc = _gather_rows(x[ops["colidx"]], pivs[li][bi])
            xc = torch.linalg.solve_triangular(L11, xc, upper=False,
                                               unitriangular=True)
            _set_cols(x, xc, ops["c_src"], ops["c_dst"])
            if Mb and ops["r_src"].shape[0]:
                _sub_rows(x, PL[:, Np:, :] @ xc, ops["r_src"],
                          ops["r_lens"], ops["r_dst"])
    return x


def _lu_usolve_impl(Lb, Ub, x, pivs, level_arrays, meta):
    """Backward: y = U \\ x (UMFPACK_U family)."""
    for li in range(len(meta) - 1, -1, -1):
        for ops, (Np, Mb, base, B) in zip(level_arrays[li], meta[li]):
            PL = _panels(Lb, base, B, Np + Mb, Np)
            U11 = torch.triu(PL[:, :Np, :]) + torch.diag_embed(ops["padeye"])
            xc = x[ops["colidx"]]
            if Mb:
                U12t = _panels(Ub, base, B, Np + Mb, Np)[:, Np:, :]
                xc = xc - U12t.transpose(1, 2) @ x[ops["rowidx"]]
            xc = torch.linalg.solve_triangular(U11, xc, upper=True)
            _set_cols(x, xc, ops["c_src"], ops["c_dst"])
    return x


def _lu_utsolve_impl(Lb, Ub, x, pivs, level_arrays, meta, conj=False):
    """Forward: y = U^{T (or H)} \\ x -- U' is lower (UMFPACK_Ut family)."""
    for li in range(len(meta)):
        for ops, (Np, Mb, base, B) in zip(level_arrays[li], meta[li]):
            PL = _panels(Lb, base, B, Np + Mb, Np)
            U11 = (torch.triu(_conj(PL[:, :Np, :], conj))
                   + torch.diag_embed(ops["padeye"]))
            xc = torch.linalg.solve_triangular(U11.transpose(1, 2),
                                               x[ops["colidx"]], upper=False)
            _set_cols(x, xc, ops["c_src"], ops["c_dst"])
            if Mb and ops["r_src"].shape[0]:
                U12t = _conj(_panels(Ub, base, B, Np + Mb, Np)[:, Np:, :],
                             conj)                     # (B, Mb, Np) = U12'
                _sub_rows(x, U12t @ xc, ops["r_src"], ops["r_lens"],
                          ops["r_dst"])
    return x


def _lu_ltsolve_impl(Lb, x, pivs, level_arrays, meta, conj=False):
    """Backward: y = P_blk' (L^{T (or H)} \\ x) -- block pivots undone last
    per supernode (UMFPACK_Lt family)."""
    for li in range(len(meta) - 1, -1, -1):
        for bi, (ops, (Np, Mb, base, B)) in enumerate(
                zip(level_arrays[li], meta[li])):
            PL = _panels(Lb, base, B, Np + Mb, Np)
            L11 = torch.tril(_conj(PL[:, :Np, :], conj), -1) + torch.eye(
                Np, dtype=Lb.dtype, device=Lb.device)
            xc = x[ops["colidx"]]
            if Mb:
                L21 = _conj(PL[:, Np:, :], conj)
                xc = xc - L21.transpose(1, 2) @ x[ops["rowidx"]]
            xc = torch.linalg.solve_triangular(L11.transpose(1, 2), xc,
                                               upper=True, unitriangular=True)
            # undo the block pivot: rows were permuted by perm at factor
            # time, so gather back through the inverse permutation
            xc = _gather_rows(xc, torch.argsort(pivs[li][bi], dim=1))
            _set_cols(x, xc, ops["c_src"], ops["c_dst"])
    return x


_SOLVE_IMPLS = {"lsolve": _lu_lsolve_impl, "usolve": _lu_usolve_impl,
                "ltsolve": _lu_ltsolve_impl, "utsolve": _lu_utsolve_impl}


def _umf_solve_body(S: UmfSymbolic, name: str, conj: bool, Lb, Ub, pivs):
    """The triangular solve ``name`` over the buffers ``Lb``/``Ub`` (their
    first plan.total entries) and the block pivots ``pivs``: a function
    z (n, k) -> x (n, k)."""
    n = S.n
    la = S.plan.solve_arrays(Lb.dtype, Lb.device)
    impl = _SOLVE_IMPLS[name]
    args = (Lb,) if name in ("lsolve", "ltsolve") else (Lb, Ub)
    extra = (conj,) if name in ("ltsolve", "utsolve") else ()

    def body(z):
        x = z.new_zeros((n + 1, z.shape[1]))
        x[:n] = z
        return impl(*args, x, pivs, la, S.plan.meta, *extra)[:n]
    return body


@dataclasses.dataclass(eq=False)
class UmfSolveNumeric:
    """The numeric that a symbolic's solve programs read, one per dtype and
    device, cached on its plan: the L and U panels (the buffers' first
    ``plan.total`` entries) and the block pivots.  ``bind_umf_numeric``
    copies a numeric in; ``bound`` says whose values these are."""

    Lb: torch.Tensor
    Ub: torch.Tensor
    pivs: tuple
    bound: Binding


def _umf_solve_numeric(S: UmfSymbolic, dt: torch.dtype,
                       dev: torch.device) -> UmfSolveNumeric:
    key = ("umf_solve_numeric", dt, dev)
    got = S.plan._cache.get(key)
    if got is None:
        tot = S.plan.total
        Lb = torch.zeros(tot, dtype=dt, device=dev)
        Ub = torch.zeros(tot, dtype=dt, device=dev)
        pivs = tuple(tuple(torch.zeros((B, Np), dtype=torch.int64,
                                       device=dev)
                           for (Np, _Mb, _base, B) in lv)
                     for lv in S.plan.meta)
        got = S.plan._cache[key] = UmfSolveNumeric(
            Lb=Lb, Ub=Ub, pivs=pivs,
            bound=Binding((Lb, Ub, *(p for lv in pivs for p in lv))))
    return got


def bind_umf_numeric(num: UmfNumeric) -> UmfSolveNumeric:
    """Make ``num`` the numeric that its symbolic's solve programs read
    and return the plan's ``UmfSolveNumeric``.  L, U and the block pivots
    are copied in only when another numeric, or other values, are there:
    repeated solves on one numeric copy nothing."""
    S = num.symbolic
    R = _umf_solve_numeric(S, num.Lb.dtype, num.Lb.device)
    tot = S.plan.total
    R.bound.load("umf.solve.bind", num, (num.Lb, num.Ub),
                 lambda: (num.Lb[:tot], num.Ub[:tot],
                          *(p for lv in num.pivs for p in lv)))
    return R


def umf_solve_program(S: UmfSymbolic, name: str, k: int, conj: bool,
                      dtype, device) -> DeviceProgram:
    """One of the four triangular solves (``name``: "lsolve", "usolve",
    "ltsolve" or "utsolve"; ``conj`` for the two transposed ones) for k
    right-hand sides, one per (symbolic, name, conj, k, dtype, device) and
    cached on the symbolic's plan, as the reference compiles its four
    solve programs once per pattern with L, U and the pivots as arguments
    (suitesparse_tpu/lu/multifrontal.py:484-561): z (n, k) -> x (n, k).
    It reads the numeric bound by ``bind_umf_numeric``."""
    dev = program_device(device)
    dt = torch_dtype(dtype)

    def make():
        R = _umf_solve_numeric(S, dt, dev)
        return _umf_solve_body(S, name, conj, R.Lb, R.Ub, R.pivs)

    return cached_program(S.plan._cache, ("umf_" + name, bool(conj), dt,
                                          int(k), dev), make, dev,
                          library=_LU_LIBRARY)


def _klu_escalate(num, A, bk, system, cm):
    """Accuracy escape hatch (ACCURACY.md, VERDICT round-2 item 5): when
    iterative refinement stalls above cm.lu.escalate_omega, the static
    row-pivot order cannot reach the reference's threshold-partial-pivoting
    accuracy class (umf_local_search.c), so re-solve through the native KLU
    Gilbert-Peierls path whose pivoting is value-dependent.  The KLU factor
    is cached on the numeric object; refactors with the same numeric object
    reuse it only if values are unchanged, so callers passing new values
    build a new UmfNumeric (the normal umf_numeric flow).
    Returns x or None when this system cannot be escalated."""
    is_c = np.issubdtype(np.dtype(num.dtype), np.complexfloating)
    if system == "A":
        transpose = False
    elif system in ("At", "Aat") and not is_c:
        transpose = True
    else:
        return None
    from . import klu as _klu
    cached = getattr(num, "_klu_esc", None)
    if cached is None:
        sy = _klu.klu_analyze(A, cm)
        cached = num._klu_esc = _klu.klu_factor(A, sy, cm)
    x = _klu.klu_solve(cached, bk, transpose=transpose)
    cm.info["umf_escalated"] = True
    return x.reshape(bk.shape)


def _refine(solve_fn, x, bk, A, system, steps, num, cm):
    """Iterative refinement (max ``steps``, omega criteria of
    umf_solve.c:194-269) on the host in float64, then the native-KLU
    escape hatch when omega stays above cm.lu.escalate_omega."""
    Ssc = A.to_scipy()
    if system == "At":
        Ssc = Ssc.conj().T
    elif system == "Aat":
        Ssc = Ssc.T
    anorm = A.norm(np.inf)
    best_x, best_omega = x, np.inf
    for it in range(steps):
        with span("umf.solve.residual"):
            r = bk - Ssc @ x
            omega = np.abs(r).max() / max(
                anorm * np.abs(x).max() + np.abs(bk).max(), 1e-300)
        cm.info[f"umf_omega_{it}"] = float(omega)
        if not np.isfinite(omega) or omega >= best_omega:
            x = best_x                # diverging/stagnating: keep the best
            break                     # (umf_solve.c stopping rule)
        best_x, best_omega = x, omega
        if omega < 1e-14:
            break
        x = x + solve_fn(r)
    esc = cm.lu.escalate_omega
    if esc and not best_omega <= esc:
        with span("umf.solve.escalate"):
            x2 = _klu_escalate(num, A, bk, system, cm)
        if x2 is not None:
            x = x2
    return x


@spanned("umf.solve")
def umf_solve(num: UmfNumeric, b: np.ndarray, system: str = "A",
              refine: Optional[int] = None, A: Optional[SparseCSC] = None,
              common: Optional[Common] = None) -> np.ndarray:
    """umfpack_*_solve: the full solve-system set (umfpack.h:379-394).

    With B = P R^{-1} A Q = L U (block pivots folded into L):
      "A"    A x = b            "At"   A^H x = b      "Aat"  A^T x = b
      "Pt_L" P'L x = b          "L"    L x = b
      "Lt_P" L^H P x = b        "Lat_P" L^T P x = b
      "Lt"   L^H x = b          "Lat"  L^T x = b
      "U_Qt" U Q' x = b         "U"    U x = b
      "Ut_Q" U^H Q x = b        "Uat_Q" U^T Q x = b
      "Ut"   U^H x = b          "Uat"  U^T x = b
    Iterative refinement (max cm.lu.refine_steps, omega criteria of
    umf_solve.c:194-269) applies to the A/At/Aat systems when the original
    A is supplied.  The triangular solves run on the factor's device; b,
    the refinement and the result are on the host.

    Spans (utils/trace): ``umf.solve`` around the call, and inside it
    ``.bind`` (where ``bind_umf_numeric`` copies a numeric in, d2d), per
    solve-program call ``.upload`` (h2d), ``.program`` (d2d) and
    ``.download`` (d2h; it waits for the device), each float64 host
    residual of the refinement as ``.residual`` (their count is the
    refinement count) and the KLU fallback as ``.escalate``.  The BTF
    path nests one ``umf.solve`` a block."""
    cm = common or default_common()
    cm.checkpoint("umf_solve")
    S = num.symbolic
    n = S.n
    host_dt = np.result_type(num.dtype, np.asarray(b).dtype, np.float64)
    if not np.issubdtype(host_dt, np.complexfloating):
        host_dt = np.float64
    b = np.asarray(b, dtype=host_dt)
    one_d = b.ndim == 1
    bk = b.reshape(n, -1)
    k = bk.shape[1]
    is_c = np.issubdtype(np.dtype(num.dtype), np.complexfloating)
    steps = cm.lu.refine_steps if refine is None else refine

    if num.bnums is not None:
        if system not in ("A", "At", "Aat"):
            raise SparseError(
                Status.NOT_AVAILABLE,
                f"factor system {system!r} unavailable on the BTF/singleton "
                f"path (blocks > 1); use A/At/Aat")
        solve_fn = functools.partial(_btf_block_solve, num, system=system)
        x = solve_fn(bk)
        if steps and A is not None:
            x = _refine(solve_fn, x, bk, A, system, steps, num, cm)
        return x.reshape(-1) if one_d else x

    def _run(name, z, conj=False):
        """z (n, k) on the host through the solve program ``name``."""
        bind_umf_numeric(num)
        prog = umf_solve_program(S, name, k, conj and is_c, num.Lb.dtype,
                                 num.Lb.device)
        with span("umf.solve.upload"):
            z = np.asarray(z)
            zt = torch.as_tensor(z, device=prog.device).to(num.Lb.dtype)
            moved("h2d", z.nbytes)
        with span("umf.solve.program"):
            xt = prog(zt)
        with span("umf.solve.download"):
            out = xt.cpu().numpy()
            moved("d2h", out.nbytes)
        return out.astype(host_dt)

    Cs = num.Cs if num.Cs is not None else np.ones(n)

    def one_solve(rhs):
        # A = R (PAQ-indexed B C);  Ax=b  <=>  B w = (b/R)[rows],
        # x[cols] = w / C   (B is the two-sided-scaled factored matrix)
        z = (rhs / num.Rs[:, None])[S.a_perm_rows, :]
        y = _run("usolve", _run("lsolve", z))
        out = np.empty((n, k), dtype=host_dt)
        out[S.a_perm_cols, :] = y / Cs[:, None]
        return out

    def one_tsolve(rhs, conj):
        # A^{H/T} x = b  <=>  B^{H/T} (P R x) = C^{-1} Q'b; Rs and Cs are
        # real so the scalings need no conjugation
        z = rhs[S.a_perm_cols, :] / Cs[:, None]
        y = _run("ltsolve", _run("utsolve", z, conj), conj)
        out = np.empty((n, k), dtype=host_dt)
        out[S.a_perm_rows, :] = y
        return out / num.Rs[:, None]

    if system == "A":
        solve_fn = one_solve
    elif system in ("At", "Aat"):
        solve_fn = lambda rhs: one_tsolve(rhs, system == "At")
    elif system in ("Pt_L", "L"):
        z = bk[S.a_perm_rows] if system == "Pt_L" else bk
        x = _run("lsolve", z)
        return x[:, 0] if one_d else x
    elif system in ("Lt_P", "Lat_P", "Lt", "Lat"):
        y = _run("ltsolve", bk, system in ("Lt_P", "Lt"))
        if system.endswith("_P"):
            out = np.empty((n, k), dtype=host_dt)
            out[S.a_perm_rows, :] = y
            y = out
        return y[:, 0] if one_d else y
    elif system in ("U_Qt", "U"):
        y = _run("usolve", bk)
        if system == "U_Qt":
            out = np.empty((n, k), dtype=host_dt)
            out[S.a_perm_cols, :] = y
            y = out
        return y[:, 0] if one_d else y
    elif system in ("Ut_Q", "Uat_Q", "Ut", "Uat"):
        y = _run("utsolve", bk, system in ("Ut_Q", "Ut"))
        if system.endswith("_Q"):
            # U^{H} (Q x) = b: x = Q^{-1} y (gather through the col perm)
            y = y[S.a_perm_cols]
        return y[:, 0] if one_d else y
    else:
        raise SparseError(Status.INVALID, f"unknown system {system!r}")

    x = solve_fn(bk)
    if steps and A is not None:
        x = _refine(solve_fn, x, bk, A, system, steps, num, cm)
    return x.reshape(-1) if one_d else x


def _btf_block_solve(num: UmfNumeric, bk: np.ndarray,
                     system: str = "A") -> np.ndarray:
    """Block substitution over the BTF form (klu_solve.c:207-219 shape).

    M = PAQ is block UPPER triangular.  "A": solve M y = P b backward over
    blocks with off-diagonal gaxpy, x = Q y.  "At"/"Aat": M^{H/T} z = Q' b
    forward over blocks, x = P' z."""
    S = num.symbolic
    sg = S.singles
    n = S.n
    kk = bk.shape[1]
    host_dt = bk.dtype
    nb = len(sg.r) - 1
    tiny = np.finfo(np.float64).tiny
    y = np.zeros((n, kk), dtype=host_dt)
    out = np.empty((n, kk), dtype=host_dt)

    def inner(idx, rhs, sys):
        bn = num.bnums[idx]
        return umf_solve(bn, rhs, system=sys,
                         A=num.bAs[idx]).reshape(rhs.shape)

    if system == "A":
        b2 = bk[sg.p]
        Srow = num.Spq_csr
        for kblk in range(nb - 1, -1, -1):
            r0, r1 = int(sg.r[kblk]), int(sg.r[kblk + 1])
            rhs = b2[r0:r1] - Srow[r0:r1, r1:] @ y[r1:]
            if r1 - r0 == 1:
                piv = num.Spq_csc[r0, r0]
                y[r0] = rhs / (piv if abs(piv) >= tiny else tiny)
            else:
                y[r0:r1] = inner(kblk, rhs, "A")
        out[sg.q] = y
        return out

    # transpose systems: M^{H/T} z = b[q], forward over blocks
    conj = system == "At"
    b2 = bk[sg.q]
    Scol = num.Spq_csc
    for kblk in range(nb):
        r0, r1 = int(sg.r[kblk]), int(sg.r[kblk + 1])
        above = Scol[:r0, r0:r1]
        upd = (above.conj() if conj else above).T @ y[:r0] if r0 else 0.0
        rhs = b2[r0:r1] - upd
        if r1 - r0 == 1:
            piv = Scol[r0, r0]
            piv = np.conj(piv) if conj else piv
            y[r0] = rhs / (piv if abs(piv) >= tiny else tiny)
        else:
            y[r0:r1] = inner(kblk, rhs, system)
    out[sg.p] = y
    return out


def umf_wsolve(num: UmfNumeric, b: np.ndarray, W=None, system: str = "A",
               **kw) -> np.ndarray:
    """umfpack_*_wsolve: identical to umf_solve — the caller-provided
    workspace contract (umfpack_wsolve.h) is meaningless under PyTorch's
    caching allocator; W is accepted and ignored for API compatibility."""
    return umf_solve(num, b, system=system, **kw)


def umf_lunz(num: UmfNumeric) -> tuple[int, int]:
    """umfpack_get_lunz analog: structural nnz of L and U, counted as the
    nonzero entries of the numeric panels (the padded dense-panel layout
    stores explicit zeros; the reference counts pattern entries)."""
    if num.bnums is not None:
        lnz = unz = sum(1 for bn in num.bnums if bn is None)
        for bn in num.bnums:
            if bn is not None:
                l2, u2 = umf_lunz(bn)
                lnz += l2
                unz += u2
        return lnz, unz
    # panel layout: Lb's diagonal block holds L (strict lower, unit diag
    # implicit) and U11 (upper); Lb below holds L21; Ub below holds U12'
    Lb = num.Lb.cpu().numpy()
    Ub = num.Ub.cpu().numpy()
    lnz = unz = 0
    for level in num.symbolic.plan.meta:
        for (Np, Mb, base, B) in level:
            Mp = Np + Mb
            PL = Lb[base:base + B * Mp * Np].reshape(B, Mp, Np)
            lu = PL[:, :Np, :]
            lnz += int(np.count_nonzero(np.tril(lu, -1))) + B * Np
            lnz += int(np.count_nonzero(PL[:, Np:, :]))
            unz += int(np.count_nonzero(np.triu(lu)))
            if Mb:
                PU = Ub[base:base + B * Mp * Np].reshape(B, Mp, Np)
                unz += int(np.count_nonzero(PU[:, Np:, :]))
    return lnz, unz


def umf_get_numeric(num: UmfNumeric) -> dict:
    """umfpack_get_numeric analog: the factor as host SciPy matrices.

    Returns {"L", "U", "P", "Q", "Rs", "Cs"}: L (unit lower, its unit
    diagonal stored) and U (upper) as float64 (complex128) CSC with sorted
    row indices, the row permutation P with the block pivots folded in,
    the column permutation Q, the row scaling Rs (of A's rows) and the
    column scaling Cs (of the factored matrix's columns), such that

        P (R^{-1} A) Q C^{-1} = L U,   i.e.
        (A / Rs[:, None])[P][:, Q] / Cs[None, :] = L @ U

    (row k of the factored matrix is row P[k] of A, column k is column
    Q[k]).  A block pivot permutes the rows of its own front, so the L
    rows of every descendant that fall in that front move with it, as
    ``_lu_lsolve_impl`` applies them.  Pattern entries of the panels are
    kept whatever their value.  The entries are gathered and sorted on the
    numeric's device, then copied to the host.  Raises
    SparseError(NOT_AVAILABLE) on a BTF numeric, whose blocks are factored
    apart."""
    if num.bnums is not None:
        raise SparseError(Status.NOT_AVAILABLE,
                          "umf_get_numeric: the BTF/singleton numeric has no "
                          "single L U; factor with lu.singletons = False")
    S = num.symbolic
    n = S.n
    dev = num.Lb.device
    # the block pivots as one permutation of the factored rows
    blk = np.arange(n, dtype=np.int64)
    for li, level in enumerate(S.plan.levels):
        for bi, b in enumerate(level):
            perm = num.pivs[li][bi].cpu().numpy()
            ok = b.colidx < n
            blk[b.colidx[ok]] = np.take_along_axis(b.colidx, perm,
                                                   axis=1)[ok]
    if not np.array_equal(np.sort(blk), np.arange(n)):
        raise SparseError(Status.SINGULAR, "umf_get_numeric: a block pivot "
                          "left its front (a singular front)")
    iblk = torch.as_tensor(np.argsort(blk), device=dev)
    ar = torch.arange(n, device=dev)
    L = [(ar, ar, torch.ones(n, dtype=num.Lb.dtype, device=dev))]
    U = []
    for b in (b for level in S.plan.levels for b in level):
        B, Np, Mb = len(b.sids), b.Np, b.Mb
        size = B * (Np + Mb) * Np
        PL, PU = (buf[b.base:b.base + size].view(B, Np + Mb, Np)
                  for buf in (num.Lb, num.Ub))
        c = torch.as_tensor(b.colidx, device=dev)            # (B, Np)
        ok = c < n
        # the front block: strictly lower L, upper U (pivoted rows)
        front = ok[:, :, None] & ok[:, None, :]
        lower = torch.ones((Np, Np), dtype=torch.bool, device=dev).tril(-1)
        rows, cols = (c[:, :, None].expand(B, Np, Np),
                      c[:, None, :].expand(B, Np, Np))
        for keep, out in ((front & lower, L), (front & ~lower, U)):
            out.append((rows[keep], cols[keep], PL[:, :Np, :][keep]))
        if Mb:
            # below the front: L21 (rows moved by the ancestors' block
            # pivots) and U12, stored transposed in Ub
            r = torch.as_tensor(b.rowidx, device=dev)        # (B, Mb)
            below = (r < n)[:, :, None] & ok[:, None, :]
            rows = r[:, :, None].expand(B, Mb, Np)[below]
            cols = c[:, None, :].expand(B, Mb, Np)[below]
            L.append((iblk[rows], cols, PL[:, Np:, :][below]))
            U.append((cols, rows, PU[:, Np:, :][below]))
    Cs = num.Cs if num.Cs is not None else np.ones(n)
    return dict(L=_host_csc(L, n), U=_host_csc(U, n),
                P=np.asarray(S.a_perm_rows)[blk],
                Q=np.asarray(S.a_perm_cols), Rs=np.asarray(num.Rs),
                Cs=np.asarray(Cs))


def _host_csc(parts, n: int):
    """The SciPy CSC matrix (float64 or complex128, row indices sorted) of
    the (rows, cols, values) tensors ``parts``, sorted on their device."""
    import scipy.sparse as sp
    rows, cols, vals = (torch.cat(p) for p in zip(*parts))
    key, order = torch.sort(cols * n + rows)
    del rows
    vals = vals[order].to(torch.complex128 if vals.is_complex()
                          else torch.float64)
    small = len(key) < np.iinfo(np.int32).max
    itype = (np.int32, torch.int32) if small else (np.int64, torch.int64)
    indptr = np.zeros(n + 1, dtype=itype[0])
    np.cumsum(torch.bincount(cols, minlength=n).cpu().numpy(),
              out=indptr[1:])
    M = sp.csc_matrix((vals.cpu().numpy(),
                       (key % n).to(itype[1]).cpu().numpy(), indptr),
                      shape=(n, n))
    M.has_sorted_indices = True
    return M


def _perm_parity(p) -> float:
    """Sign of a permutation vector (determinant of its permutation
    matrix), by cycle counting: sign = (-1)^(n - #cycles)."""
    p = np.asarray(p, dtype=np.int64)
    n = p.size
    seen = np.zeros(n, dtype=bool)
    sign = 1.0
    for i in range(n):
        if seen[i]:
            continue
        j, length = i, 0
        while not seen[j]:
            seen[j] = True
            j = int(p[j])
            length += 1
        if length % 2 == 0:
            sign = -sign
    return sign


def umf_determinant(num: UmfNumeric) -> tuple[float, float]:
    """umfpack_get_determinant: (mantissa, exponent10) of det(A).

    Permutation parity is accounted exactly (umfpack_get_determinant.c):
    fill/matching row+col perms, BTF perms, and the per-block partial
    pivots each contribute their sign.
    """
    if num.bnums is not None:
        # product over blocks: 1x1 pivots and inner determinants;
        # det(A) = parity(p)·parity(q)·prod(det(diag blocks of PAQ))
        sg = num.symbolic.singles
        logdet = 0.0
        sign = _perm_parity(sg.p) * _perm_parity(sg.q)
        for k, bn in enumerate(num.bnums):
            r0 = int(sg.r[k])
            if bn is None:
                piv = num.Spq_csc[r0, r0]
                sign *= np.sign(piv) if piv != 0 else 0.0
                logdet += np.log(max(abs(piv),
                                     np.finfo(np.float64).tiny))
            else:
                m_k, e_k = umf_determinant(bn)
                sign *= np.sign(m_k) if not np.iscomplexobj(np.asarray(m_k)) \
                    else m_k / max(abs(m_k), 1e-300)
                logdet += np.log(max(abs(m_k), 1e-300)) + e_k * np.log(10.0)
        e = np.floor(logdet / np.log(10.0))
        m = sign * np.exp(logdet - e * np.log(10.0))
        if np.iscomplexobj(m):
            return complex(m), float(e)
        return float(m), float(e)
    S = num.symbolic
    ss = S.ss
    h = num.Lb.cpu().numpy()
    logdet = 0.0
    # det(A) = parity(a_perm_rows)·parity(a_perm_cols)·parity(block pivots)
    #          · prod(diag U) · prod(Rs)
    sign = _perm_parity(S.a_perm_rows) * _perm_parity(S.a_perm_cols)
    for level_pivs in num.pivs:
        for pv in level_pivs:
            for row in pv.cpu().numpy():
                sign *= _perm_parity(row)
    for s in range(ss.nsuper):
        ms, ns = ss.panel_shape(s)
        Np, Mp = int(ss.panel_Np[s]), int(ss.panel_Mp[s])
        o = int(ss.panel_off[s])
        panel = h[o:o + Mp * Np].reshape(Mp, Np)
        d = np.diag(panel[:ns, :ns])
        sign *= np.prod(np.sign(d))
        logdet += np.sum(np.log(np.abs(d)))
    # two-sided scaling: the factored matrix is R^{-1} A C^{-1} (permuted),
    # so det(A) = det(B) · prod(Rs) · prod(Cs)
    logdet += np.sum(np.log(num.Rs))
    if num.Cs is not None:
        logdet += np.sum(np.log(num.Cs))
    e = np.floor(logdet / np.log(10.0))
    m = sign * np.exp(logdet - e * np.log(10.0))
    if np.iscomplexobj(m):
        return complex(m), float(e)
    return float(m), float(e)
