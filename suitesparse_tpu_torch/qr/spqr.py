"""SPQR-class multifrontal sparse QR in PyTorch (CPU or CUDA).

Counterpart of suitesparse_tpu/qr/spqr.py.  Reference behavior targeted
(SPQR): symbolic analysis = supernodal analysis of A'A (spqr_analyze.cpp
uses cholmod_analyze_p2); numeric = per-front dense Householder QR with
child contribution blocks assembled in staircase form (spqr_front.cpp);
rank detection with tol = 20*(m+n)*eps*max column 2-norm
(SuiteSparseQR_definitions.h:28, spqr_tol.cpp); least-squares solve via
Q'b carried through the factorization + R backsolve (SuiteSparseQR<Entry>).

The host analysis -- the padded shape buckets of each elimination-tree
level, the static staircase-assembly maps and the Q'X output layout -- is
the reference's, built with NumPy a supernode, a bucket or a level at a
time, so the symbolic objects are identical.  The numeric phase is one
device program (``qr_program``, a captured CUDA graph on the card) over
the values put in the factored order by a map made once per pattern
(``_qr_value_map``).  On the card, per bucket, the real fronts above 256
rows go through ``front_qr``: a blocked Householder QR whose panels are
the hand-written kernel ``csrc/qr_panel.cu``, which also applies each
reflector to up to 32 right-hand sides as SPQR carries B beside the front
(no Q is formed), and whose trailing updates are float64 GEMMs; the other
buckets (at most 256 rows or complex), and every bucket on the host, take
one batched ``torch.geqrf`` and, with a right-hand side, one
``torch.ormqr``.  Both write LAPACK's layout, which the output maps read.
Every assembly and output scatter is a non-atomic indexed write through
sorted, unique maps and the panel kernel sums in a fixed order, so two
refactorizations on the card are bit-identical.  The fronts are
factored in float64 (complex128) whatever R's dtype, and a float32 R is
rounded once as each front writes it (``front_dtype``).  ``keep_q`` also
keeps each front's complete Q on the host (``qr_qmult``).  R x = c runs on
the device through the Cholesky solve program's back substitution
(``super_numeric.solve_program``, system "Lt"): R's panels hold R^T in the
layout of the Cholesky factor's panels.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, SYM_UPPER
from ..core.status import SparseError, Status
from ..cholesky.supernodal import SuperSymbolic, super_symbolic, _pad_dim
from ..cholesky.symbolic import Symbolic, analyze
from ..cholesky.super_numeric import (NumericPlan, _index, _solve_factor,
                                      build_plan, solve_program,
                                      sorted_scatter_maps)
from ..utils import cuda_build
from ..utils.device import (default_dtype, numpy_dtype, resolve_device,
                            torch_dtype)
from ..utils.programs import (DeviceProgram, PatternMap, cached_program,
                              pattern_map, program_device)
from ..utils.trace import moved, span, spanned


def _sorted_pair(bq, key: str, src: np.ndarray, dst: np.ndarray):
    """Cache (src, dst) reordered by destination so the assembly scatter can
    promise sorted+unique indices (vectorized one-pass update on TPU; same
    lowering trick as the Cholesky extend-add, NOTES_ROUND1.md)."""
    maps = getattr(bq, key)
    if maps is None:
        dst = np.asarray(dst)
        order = np.argsort(dst, kind="stable")
        maps = (np.asarray(src)[order].astype(INDEX),
                dst[order].astype(INDEX))
        setattr(bq, key, maps)
    return maps


def _sorted_drop(bq, key: str, dst: np.ndarray, trash: int):
    """Cache (src, dst) maps for an output scatter whose pad entries point
    at the single trash slot: drop pads on the host, sort by destination."""
    maps = getattr(bq, key)
    if maps is None:
        flat = np.asarray(dst).reshape(-1)
        maps = sorted_scatter_maps(np.where(flat == trash, -1, flat))
        setattr(bq, key, maps)
    return maps


def _ragged(counts) -> tuple[np.ndarray, np.ndarray]:
    """(segment, position) of each element of consecutive segments of
    ``counts[k]`` elements each."""
    counts = np.asarray(counts, dtype=np.int64)
    seg = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    starts = np.cumsum(counts) - counts
    return seg, np.arange(len(seg), dtype=np.int64) - starts[seg]


def _runs(counts: torch.Tensor):
    """(run, position) of each element of consecutive runs of
    ``counts[k]`` elements each, on the device of ``counts``."""
    n = int(counts.sum())
    seg = torch.repeat_interleave(
        torch.arange(len(counts), device=counts.device), counts,
        output_size=n)
    start = torch.cumsum(counts, 0) - counts
    return seg, torch.arange(n, device=counts.device) - start[seg]


@dataclasses.dataclass
class _QRBucket:
    """One (level, shape) bucket of fronts.  The small maps are arrays;
    the large ones -- the C-block assembly (``c_src``/``c_dst``) and the
    padded output maps ``r_dst`` and ``c_out_dst`` -- are kept as runs of
    consecutive entries (``_c_runs``, ``_r_runs``, ``_cout_runs``) and
    expanded on demand: on the device by ``_device_plan``, on the host by
    the properties."""

    sids: np.ndarray
    FR: int                   # padded front rows
    FC: int                   # padded front cols
    Np: int                   # padded pivotal column count
    # assembly maps (flat indices into the level workspace of this bucket)
    a_src: np.ndarray         # indices into the A-value vector
    a_dst: np.ndarray         # -> workspace flat positions
    b_rows: np.ndarray        # (B, FR) original A-row id carried into front
                              # rows (for stacking B), -1 = child/pad row
    c_brow_src: np.ndarray    # C carried-B buffer sources (flat)
    c_brow_dst: np.ndarray    # -> (b, front_row) flattened positions
    # outputs
    cb_out_dst: np.ndarray    # (B, FR): C-rows -> carried-B buffer row (+1-based? -1 pad)
    colidx: np.ndarray        # (B, Np) global pivotal columns (n = pad)
    rowidx: np.ndarray        # (B, FCmNp) global beyond cols (n = pad)
    ns: np.ndarray            # (B,) true pivotal widths
    fr: np.ndarray            # (B,) true front row counts
    # runs: per child C row (C-buffer start, workspace row start, width,
    # start of the child's columns in the parent in kid_col); per front
    # and R column k (front, k, rows t, panel start); per front and C row
    # (front, row, width, C-buffer start); the children in assembly order
    _c_runs: tuple = None
    _r_runs: tuple = None
    _cout_runs: tuple = None
    _kids: np.ndarray = None
    _kid_col: np.ndarray = None     # the symbolic's, shared
    _r_trash: int = 0
    _c_trash: int = 0
    # cached sorted scatter maps (built lazily by _sorted_pair/_sorted_drop;
    # declared so slots=True/frozen variants would not silently break them)
    _a_maps: tuple = None
    _c_maps: tuple = None
    _cb_maps: tuple = None
    _cbout_maps: tuple = None

    def c_map(self, dev, kid_col: torch.Tensor) -> tuple:
        """(C-buffer position, workspace position) of each C-block entry
        assembled here, in assembly order (destinations ascending)."""
        start, wrow, width, col = (torch.as_tensor(a, device=dev)
                                   for a in self._c_runs)
        seg, k = _runs(width)
        return start[seg] + k, wrow[seg] + kid_col[col[seg] + k]

    def r_map(self, dev, stride: int) -> tuple:
        """(position in the fronts' R, panel position) of each R entry,
        panel positions ascending: R[b, t, k] read at (b FC + k) stride +
        t (stride Np: r_dst's padded layout; FR: geqrf's column-major
        output)."""
        b, k, rows, pstart = (torch.as_tensor(a, device=dev)
                              for a in self._r_runs)
        seg, t = _runs(rows)
        return (b[seg] * self.FC + k[seg]) * stride + t, pstart[seg] + t

    def cout_map(self, dev, upper: bool = False, off=None) -> tuple:
        """(position in the fronts' R, C-buffer position) of each C-block
        entry a front writes: the whole block in c_out_dst's padded
        (B, FR, FC) layout, or with ``upper`` only the entries on and above
        R's diagonal, read in geqrf's column-major output and written at
        the fronts' starts ``off`` (a C buffer in another order)."""
        b, rr, width, start = (torch.as_tensor(a, device=dev)
                               for a in self._cout_runs)
        ns = torch.as_tensor(self.ns, device=dev)[b]
        if off is not None:
            start = torch.as_tensor(off, device=dev)
        lo = rr if upper else torch.zeros_like(rr)
        seg, j = _runs((width - lo).clamp_min(0))
        k = lo[seg] + j
        b, rr, ns = b[seg], rr[seg], ns[seg]
        dst = start[seg] + rr * width[seg] + k
        if upper:
            return (b * self.FC + ns + k) * self.FR + ns + rr, dst
        return (b * self.FR + ns + rr) * self.FC + ns + k, dst

    @property
    def c_src(self) -> np.ndarray:
        """C-block entries' C-buffer positions (assembly order)."""
        return self.c_map("cpu", torch.as_tensor(self._kid_col))[0].numpy()

    @property
    def c_dst(self) -> np.ndarray:
        """C-block entries' workspace positions (assembly order)."""
        return self.c_map("cpu", torch.as_tensor(self._kid_col))[1].numpy()

    @property
    def r_dst(self) -> np.ndarray:
        """(B, FC, Np): workspace R rows -> R panel flat (trash: pad)."""
        out = np.full((len(self.sids), self.FC, self.Np), self._r_trash,
                      dtype=INDEX)
        src, dst = self.r_map("cpu", self.Np)
        out.reshape(-1)[src.numpy()] = dst.numpy()
        return out

    @property
    def c_out_dst(self) -> np.ndarray:
        """(B, FR, FC): C-block rows -> C buffer flat (trash: pad)."""
        out = np.full((len(self.sids), self.FR, self.FC), self._c_trash,
                      dtype=INDEX)
        src, dst = self.cout_map("cpu")
        out.reshape(-1)[src.numpy()] = dst.numpy()
        return out


@dataclasses.dataclass
class QRSymbolic:
    m: int
    n: int
    sym: Symbolic             # of the A'A pattern (perm = column ordering)
    ss: SuperSymbolic
    levels: list              # list[list[_QRBucket]]
    total_R: int              # flat R panel storage (ss.total)
    total_C: int              # flat C buffer size
    c_off: np.ndarray         # per supernode offset into C buffer
    cb_off: np.ndarray        # per supernode offset into carried-B rows
    total_CB: int             # total carried-B rows
    arow_of_front: list       # per supernode: A-row ids assembled there
    # the plan of R's panels (the Cholesky layout of ss): the R solve
    # walks it, and the QR and R-solve programs are cached on its _cache
    plan: Optional[NumericPlan] = None
    # where each supernode's beyond-pivot rows sit in its parent's row
    # list (its C block's columns in the parent's front), supernode by
    # supernode: the buckets' C runs index it
    _kid_col: Optional[np.ndarray] = None


class _Fronts:
    """Per-supernode quantities of the QR fronts, as arrays, and the lookup
    of a row's local position in a supernode's sorted row list."""

    def __init__(self, ss: SuperSymbolic, n: int):
        self.ss = ss
        self.n = n
        self.sup = ss.super.astype(np.int64)
        self.rowptr = ss.sn_rowptr.astype(np.int64)
        self.ns = np.diff(self.sup)
        self.ms = np.diff(self.rowptr)
        self.cc = self.ms - self.ns
        # (supernode, row) keys of every panel row, sorted: each
        # supernode's rows are sorted, so one search finds a local index
        self.keys = (np.repeat(np.arange(ss.nsuper, dtype=np.int64), self.ms)
                     * (n + 1) + ss.sn_rows)

    def local(self, s: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Position of each row ``rows[i]`` in supernode ``s[i]``'s rows
        (each must be there)."""
        want = s * (self.n + 1) + rows
        at = np.searchsorted(self.keys, want)
        if len(at) and not np.array_equal(
                self.keys[np.minimum(at, len(self.keys) - 1)], want):
            raise AssertionError("qr_symbolic: a front row outside the "
                                 "supernode's row list")
        return at - self.rowptr[s]


@spanned("qr.symbolic")
def qr_symbolic(A: SparseCSC, common: Optional[Common] = None) -> QRSymbolic:
    """Column ordering and supernodes of A'A, the fronts' row counts and
    every bucket's static maps.

    Spans (utils/trace): ``qr.symbolic`` around the call, with the
    ordering's and the supernodal analysis's spans inside it,
    ``plan.qr_rows`` (A's rows to their fronts and the front sizes),
    ``plan.qr_maps`` (the buckets' maps) and ``plan.build_plan`` (the
    layout of R's panels that the R solve walks)."""
    cm = common or default_common()
    cm.checkpoint("qr_symbolic")
    m, n = A.shape
    if A.stype != 0:
        A = A.to_full_storage()
    import scipy.sparse as sp

    S = A.to_scipy().tocsc()
    # structural A'A (ones, not values: numeric cancellation or explicit
    # zeros must not shrink the analysis pattern below the assembly maps)
    Spat = sp.csc_matrix((np.ones(S.nnz), S.indices.copy(),
                          S.indptr.copy()), shape=S.shape)
    AtA = (Spat.T @ Spat).tocsc()
    U = sp.triu(AtA).tocsc()
    Asym = SparseCSC(U.indptr.astype(INDEX), U.indices.astype(INDEX),
                     np.ones(U.nnz), U.shape, stype=SYM_UPPER)
    cm.cholesky.supernodal = "supernodal"
    sym = analyze(Asym, cm)
    ss = super_symbolic(Asym, sym, cm)
    nsuper = ss.nsuper
    fx = _Fronts(ss, n)

    with span("plan.qr_rows"):
        p = sym.perm                      # column ordering
        Ap = SparseCSC.from_scipy(S[:, p].tocsc())   # A with permuted cols
        ApT = Ap.to_scipy().tocsr()
        a_ptr = ApT.indptr.astype(np.int64)
        # leftmost column (in permuted order) of each row, -1 if empty
        leftmost = np.full(m, -1, dtype=INDEX)
        full = np.diff(a_ptr) > 0
        if full.any():
            leftmost[full] = np.minimum.reduceat(ApT.indices, a_ptr[:-1][full])
        # the rows each front assembles: those whose leftmost column is
        # one of its pivotal columns, in ascending order
        rows_h = np.nonzero(leftmost >= 0)[0]
        s_of = ss.col_to_super[leftmost[rows_h]].astype(np.int64)
        arow_all = rows_h[np.argsort(s_of, kind="stable")].astype(INDEX)
        na = np.bincount(s_of, minlength=nsuper).astype(np.int64)
        arow_ptr = np.concatenate([[0], np.cumsum(na)])
        arow_of_front = np.split(arow_all, arow_ptr[1:-1])

        # children of each supernode in ascending order (the postorder
        # visits them first)
        par = ss.sn_parent.astype(np.int64)
        nonroot = np.nonzero(par >= 0)[0]
        kids = nonroot[np.argsort(par[nonroot], kind="stable")]
        nkids = np.bincount(par[nonroot], minlength=nsuper).astype(np.int64)
        kid_ptr = np.concatenate([[0], np.cumsum(nkids)])

        # bottom-up front row counts and C-block sizes (a supernode loop:
        # each front waits for its children's C rows)
        frows = np.zeros(nsuper, dtype=INDEX)
        crows = np.zeros(nsuper, dtype=INDEX)
        csum = [0] * nsuper
        na_l, ns_l, cc_l, par_l = (na.tolist(), fx.ns.tolist(),
                                   fx.cc.tolist(), par.tolist())
        for s in range(nsuper):       # postorder: children first
            fr = na_l[s] + csum[s]
            cr = max(0, min(fr - ns_l[s], cc_l[s])) if cc_l[s] > 0 else 0
            frows[s], crows[s] = fr, cr
            if par_l[s] != -1:
                csum[par_l[s]] += cr

        c_off = np.zeros(nsuper + 1, dtype=INDEX)
        np.cumsum(crows * fx.cc, out=c_off[1:])
        cb_off = np.zeros(nsuper + 1, dtype=INDEX)
        np.cumsum(crows, out=cb_off[1:])

        # where each supernode's beyond-pivot rows sit in its parent's
        # row list (the columns of its C block in the parent's front)
        seg, pos = _ragged(fx.cc)
        kid_col = np.zeros(len(seg), dtype=np.int64)
        up = par[seg] >= 0
        kid_col[up] = fx.local(par[seg][up], ss.sn_rows[
            (fx.rowptr[seg] + fx.ns[seg] + pos)[up]])
        kid_col_ptr = np.cumsum(fx.cc) - fx.cc

    arrays = dict(ApT=ApT, a_ptr=a_ptr, arow_all=arow_all,
                  arow_ptr=arow_ptr, na=na, kids=kids, nkids=nkids,
                  kid_ptr=kid_ptr, frows=frows, crows=crows, c_off=c_off,
                  cb_off=cb_off, kid_col=kid_col, kid_col_ptr=kid_col_ptr)
    levels_out = []
    with span("plan.qr_maps"):
        for level in ss.levels:
            groups: dict[tuple, list[int]] = {}
            for s in level.tolist():
                key = (_pad_dim(max(int(frows[s]), 1)),
                       _pad_dim(int(fx.ms[s])), _pad_dim(int(fx.ns[s])))
                groups.setdefault(key, []).append(s)
            levels_out.append([
                _qr_bucket(fx, arrays, np.array(sids, dtype=INDEX), *key)
                for key, sids in sorted(groups.items())])
    plan = build_plan(ss)
    return QRSymbolic(m=m, n=n, sym=sym, ss=ss, levels=levels_out,
                      total_R=ss.total, total_C=int(c_off[-1]),
                      c_off=c_off, cb_off=cb_off, total_CB=int(cb_off[-1]),
                      arow_of_front=arow_of_front, plan=plan,
                      _kid_col=kid_col)


def _qr_bucket(fx: _Fronts, ar: dict, sids: np.ndarray, FR: int, FC: int,
               Np: int) -> _QRBucket:
    """One bucket's maps, vectorized over its fronts: the reference's
    per-entry loops (suitesparse_tpu/qr/spqr.py) give the same arrays, in
    the same order."""
    ss, n = fx.ss, fx.n
    B = len(sids)
    ms, ns = fx.ms[sids], fx.ns[sids]
    fr = ar["frows"][sids].astype(np.int64)
    crows = ar["crows"].astype(np.int64)
    c_off, cb_off = ar["c_off"], ar["cb_off"]
    colidx = np.full((B, Np), n, dtype=INDEX)
    g, q = _ragged(ns)
    colidx[g, q] = fx.sup[sids][g] + q
    rowidx = np.full((B, FC), n, dtype=INDEX)
    g, q = _ragged(ms - ns)
    rowidx[g, q] = ss.sn_rows[fx.rowptr[sids][g] + ns[g] + q]

    # A rows stack first: front b's rofs-th row is A row b_rows[b, rofs],
    # each of its entries t lands in the front's column of its own column
    b_rows = np.full((B, FR), -1, dtype=INDEX)
    fa, rofs = _ragged(ar["na"][sids])
    rows_a = ar["arow_all"][ar["arow_ptr"][sids][fa] + rofs]
    b_rows[fa, rofs] = rows_a
    ApT, a_ptr = ar["ApT"], ar["a_ptr"]
    e, t = _ragged(a_ptr[rows_a + 1] - a_ptr[rows_a])
    a_src = a_ptr[rows_a][e] + t
    fe = fa[e]
    a_dst = (fe * FR * FC + rofs[e] * FC
             + fx.local(sids[fe], ApT.indices[a_src]))

    # children's C blocks below them, child by child in ascending order:
    # a run per C row
    fp, kq = _ragged(ar["nkids"][sids])
    kid = ar["kids"][ar["kid_ptr"][sids][fp] + kq]
    kcr = crows[kid]
    before = np.cumsum(kcr) - kcr          # C rows of earlier pairs
    first = np.cumsum(ar["nkids"][sids]) - ar["nkids"][sids]
    crofs = ar["na"][sids][fp] + before - before[first[fp]] if len(fp) \
        else before
    pr, rr = _ragged(kcr)                  # (pair, C row)
    c_brow_src = cb_off[kid[pr]] + rr
    c_brow_dst = fp[pr] * FR + crofs[pr] + rr
    kpr = kid[pr]
    c_runs = (c_off[kpr] + rr * fx.cc[kpr],
              fp[pr] * FR * FC + (crofs[pr] + rr) * FC, fx.cc[kpr],
              ar["kid_col_ptr"][kpr])

    # R output: workspace row t (t < min(fr, ms, ns)) col k ->
    # R panel (padded normalized layout) Rpanel[norm(k), t]: a run per
    # front and k, fronts in panel order
    po = ss.panel_off[sids].astype(np.int64)
    pnp = ss.panel_Np[sids].astype(np.int64)
    order = np.argsort(po, kind="stable")
    fk, kk = _ragged(ms[order])
    fk = order[fk]
    tmax = np.minimum(np.minimum(fr, ms), ns)
    nk = np.where(kk < ns[fk], kk, pnp[fk] + kk - ns[fk])
    r_runs = (fk, kk, np.minimum(kk + 1, tmax[fk]), po[fk] + nk * pnp[fk])
    # C out: workspace rows ns..ns+crows, cols ns.. -> C buffer, a run per
    # C row
    cr_b = crows[sids]
    fc, rc = _ragged(cr_b)
    cout_runs = (fc, rc, (ms - ns)[fc], c_off[sids][fc])
    cb_out_dst = np.full((B, FR), int(cb_off[-1]), dtype=INDEX)
    g, q = _ragged(cr_b)
    cb_out_dst[g, ns[g] + q] = cb_off[sids][g] + q
    ix = lambda a: np.asarray(a, dtype=INDEX)  # noqa: E731
    return _QRBucket(
        sids=sids, FR=FR, FC=FC, Np=Np, a_src=ix(a_src), a_dst=ix(a_dst),
        b_rows=b_rows, c_brow_src=ix(c_brow_src), c_brow_dst=ix(c_brow_dst),
        cb_out_dst=cb_out_dst, colidx=colidx, rowidx=rowidx, ns=ix(ns),
        fr=ix(fr), _c_runs=tuple(map(ix, c_runs)),
        _r_runs=tuple(map(ix, r_runs)), _cout_runs=tuple(map(ix, cout_runs)),
        _kids=ix(kid), _kid_col=ar["kid_col"], _r_trash=int(ss.total),
        _c_trash=int(c_off[-1]))


@dataclasses.dataclass
class QRNumeric:
    symbolic: QRSymbolic
    Rbuf: torch.Tensor        # flat R panels (+1 trash), on the device
    qtb: np.ndarray           # Q'b top rows per pivotal column, (n, k)
    rank: int
    tol: float
    dtype: object
    # per-(level, bucket) complete-mode front Q blocks (B, FR, FR), host --
    # the analog of SPQR's Householder (H/HTau/HPinv) storage; present only
    # when factorized with keep_q=True (enables qr_qmult).
    Qs: Optional[list] = None

    @property
    def ok(self) -> bool:
        return self.rank == min(self.symbolic.m, self.symbolic.n)


def _c_layout(S: QRSymbolic) -> tuple:
    """The program's C buffer: the C blocks in the order the buckets read
    them (the level loop's order, then each bucket's assembly order), so
    that a bucket's C entries are one slice of it.  Returns (each
    supernode's block start, each bucket's (start, end) in level
    order)."""
    got = S.plan._cache.get("qr_c_layout")
    if got is None:
        size = np.diff(S.c_off)
        off = np.zeros(S.ss.nsuper, dtype=np.int64)
        reads, pos = [], 0
        for bq in (bq for lv in S.levels for bq in lv):
            sz = size[bq._kids]
            off[bq._kids] = pos + np.cumsum(sz) - sz
            reads.append((pos, pos + int(sz.sum())))
            pos += int(sz.sum())
        got = S.plan._cache["qr_c_layout"] = (off, reads)
    return got


def _bucket_maps(S: QRSymbolic, bq: _QRBucket, dev: torch.device,
                 kid_col: torch.Tensor, read: tuple, off: np.ndarray) -> dict:
    """Device index maps of one bucket's level step: (source, destination)
    index tensors, but for "c": (start, end, destination), a slice of the
    program's C buffer (``_c_layout``).  The assembly of A's rows is the
    reference's sorted map (_sorted_pair); the large maps are expanded on
    the device from the bucket's runs.  The output maps gather straight
    out of the fronts' ``geqrf`` output QR (B, FR, FC), read through its
    column-major storage, flat (b, c, r) -> (b FC + c) FR + r, and out of
    Q'B (B, FR, k): every target is one the reference writes, with the
    same value.  R's entries lie on and above the diagonal, where QR holds
    R; the C-block entries below the diagonal, where QR holds Householder
    vectors and R is zero, are left out (the C buffer starts zero)."""
    B, FR = len(bq.sids), bq.FR
    ix = lambda a: _index(a, dev)  # noqa: E731
    out = {}
    if len(bq.a_src):
        out["a"] = tuple(map(ix, _sorted_pair(bq, "_a_maps", bq.a_src,
                                              bq.a_dst)))
    if read[1] > read[0]:
        out["c"] = (*read, bq.c_map(dev, kid_col)[1])
    br = bq.b_rows.reshape(-1)
    ok = np.nonzero(br >= 0)[0]
    out["b"] = (ix(br[ok]), ix(ok))
    if len(bq.c_brow_src):
        out["cb"] = tuple(map(ix, _sorted_pair(bq, "_cb_maps", bq.c_brow_src,
                                               bq.c_brow_dst)))
    out["r"] = bq.r_map(dev, FR)
    out["cout"] = bq.cout_map(dev, upper=True,
                              off=off[bq.sids[bq._cout_runs[0]]])
    # carried rows of Q'B -> carried-B buffer
    out["cbout"] = tuple(map(ix, _sorted_drop(bq, "_cbout_maps",
                                              bq.cb_out_dst, S.total_CB)))
    # Q'b's top rows -> qtb rows (the pivotal columns; unique over fronts)
    g, q = _ragged(np.minimum(bq.ns, FR))
    out["qtb"] = (ix(g * FR + q), ix(bq.colidx[g, q]))
    return out


def _diag_index(S: QRSymbolic) -> np.ndarray:
    """Flat positions of R's diagonal in the panel buffer, in column
    order (the reference reads np.diag of each supernode's panel)."""
    ss = S.ss
    s, t = _ragged(np.diff(ss.super))
    return (ss.panel_off[s] + t * (ss.panel_Np[s] + 1)).astype(INDEX)


def _device_plan(S: QRSymbolic, dev: torch.device) -> list:
    """Every bucket's maps on ``dev``, cached on the symbolic's plan per
    device."""
    key = ("qr_maps", dev)
    got = S.plan._cache.get(key)
    if got is None:
        with span("plan.qr_device_maps"):
            off, reads = _c_layout(S)
            kid_col = _index(S._kid_col, dev)
            it = iter(reads)
            got = S.plan._cache[key] = [
                [_bucket_maps(S, bq, dev, kid_col, next(it), off)
                 for bq in lv] for lv in S.levels]
    return got


def r_diagonal(S: QRSymbolic, Rbuf: torch.Tensor) -> np.ndarray:
    """R's diagonal in the permuted column order, on the host in float64
    (complex128): n numbers gathered on the device through one cached
    index vector, not the whole R buffer copied."""
    cache = S.__dict__.setdefault("_diag_index", {})
    idx = cache.get(Rbuf.device)
    if idx is None:
        idx = cache[Rbuf.device] = _index(_diag_index(S), Rbuf.device)
    d = Rbuf[idx].cpu().numpy()
    return d.astype(np.complex128 if np.iscomplexobj(d) else np.float64)


def _complete_q(QR: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The (B, FR, FR) complete Q of the fronts' geqrf output, as
    torch.linalg.qr(mode="complete") forms it."""
    B, FR, FC = QR.shape
    if FR > FC:
        Q = QR.new_zeros((B, FR, FR))
        Q[:, :, :FC] = QR
    else:
        Q = QR[:, :, :FR]
    return torch.linalg.householder_product(Q, tau)


def front_dtype(dtype: torch.dtype) -> torch.dtype:
    """The precision the fronts are factored in for an R of ``dtype``:
    float64 (complex128) for float32 (complex64) and for float64.

    Householder QR of a float32 front is not accurate enough at the sizes
    a 3-D problem's top fronts reach.  On the 38,326 x 7,820 root front of
    the 64^3 phase-unwrapping matrix, max |W^T W - R^T R| / max_j
    ||w_j||^2 reads 1.9e-6 to 2.4e-3 with cuSOLVER's float32 geqrf,
    depending on the values and on the rows' order, and 3.5e-5 with
    LAPACK's on the CPU; in float64 it reads 1.8e-14.  So the fronts, the
    C blocks passed up the tree and Q'B are float64, and R is rounded to
    its own dtype once, as each front writes it."""
    return torch.complex128 if dtype.is_complex else torch.float64


# On the card the fronts above QR_KERNEL_ROWS rows, in float64, are
# factored by ``front_qr``: a blocked Householder QR whose panels of
# QR_PANEL columns are the hand-written kernel csrc/qr_panel.cu and whose
# trailing updates are float64 GEMMs, QR_OUTER columns at a time.  Smaller
# fronts stay with cuSOLVER's batched geqrf, and the host with LAPACK's.
QR_KERNEL_ROWS = 256
QR_PANEL = 32
QR_OUTER = 128
QR_PANEL_RHS = 32             # right-hand sides the panel kernel carries
# csrc/qr_panel.cu's shape: warps a CTA (kWarps), the rows a thread may
# hold, the largest cluster (kClusterMax) and the doubles of one CTA's
# message (kMsg); a thread holds 8 rows while CTAs are free
_PANEL_WARPS = 16
_PANEL_RPT = (8, 16, 24, 32)
_PANEL_CLUSTER = 16
_PANEL_MSG = 2 * QR_PANEL + 2 * QR_PANEL_RHS
_PANEL_RPT_PREF = 8


def panel_tiling(rows: int, sms: int) -> Optional[tuple]:
    """(G, rpt) of a panel of ``rows`` rows on a card of ``sms`` SMs: the
    CTAs that hold each front's rows (1: one CTA; up to 16: a cluster;
    more: a cooperative grid of at most one CTA an SM) and the rows each
    thread of their 16 warps holds; None where the rows do not fit."""
    G = -(-rows // (_PANEL_WARPS * _PANEL_RPT_PREF))
    if G > _PANEL_CLUSTER:
        G = min(G, sms)
    need = -(-rows // (G * _PANEL_WARPS))
    return next(((G, r) for r in _PANEL_RPT if r >= need), None)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def front_qr_takes(FR: int, dtype: torch.dtype,
                   device: torch.device) -> bool:
    """Whether ``front_qr`` factors a bucket of FR-row fronts in ``dtype``
    on ``device``: real float64 fronts above QR_KERNEL_ROWS rows on the
    card, no taller than a grid of one CTA an SM holds (SMs x 512 rows,
    67,584 on an H100).  The host keeps LAPACK's blocked geqrf, which
    ``front_qr_plain``'s column-by-column arithmetic does not beat."""
    return (device.type == "cuda" and FR > QR_KERNEL_ROWS
            and dtype == torch.float64
            and panel_tiling(FR, _sm_count(device)) is not None)


def _larfb(Ct: torch.Tensor, Vt: torch.Tensor, T: torch.Tensor) -> None:
    """C = (I - V T V')' C in place, through C's transpose ``Ct`` (B, nc,
    m), ``Vt`` = V' (B, k, m) and T (B, k, k): three batched GEMMs."""
    Y = torch.bmm(torch.bmm(Ct, Vt.transpose(1, 2)), T)
    Ct.baddbmm_(Y, Vt, alpha=-1.0)


def _front_qr(W: torch.Tensor, WB: Optional[torch.Tensor], panel) -> tuple:
    """Blocked Householder QR of the (B, FR, FC) fronts ``W``: blocks of
    QR_OUTER columns, each factored QR_PANEL columns at a time by
    ``panel``, which also writes each panel's T and V and carries ``WB``;
    each panel's block reflector updates the rest of its outer block and,
    where columns lie beyond the block, the block's T is merged from its
    panels' (T12 = -T11 V1'V2 T22) and one block reflector of QR_OUTER
    columns updates the rest of the front."""
    B, FR, FC = W.shape
    At = W.transpose(1, 2).contiguous()       # each front column-major
    K = min(FR, FC)
    tau = W.new_zeros((B, K))
    tld = min(QR_OUTER, K)
    T = W.new_zeros((B, tld, tld))
    Vt = W.new_empty((B, tld, FR))
    for j0 in range(0, K, QR_OUTER):
        jb, m = min(QR_OUTER, K - j0), FR - j0
        beyond = j0 + jb < FC
        for p0 in range(j0, j0 + jb, QR_PANEL):
            pb, l0 = min(QR_PANEL, j0 + jb - p0), p0 - j0
            panel(At, tau, T, Vt, WB, p0, pb, j0)
            Vp, Tp = Vt[:, l0:l0 + pb, l0:m], T[:, l0:l0 + pb, l0:l0 + pb]
            if p0 + pb < j0 + jb:
                _larfb(At[:, p0 + pb:j0 + jb, p0:], Vp, Tp)
            if l0 and beyond:
                S = torch.bmm(Vt[:, :l0, l0:m], Vp.transpose(1, 2))
                T[:, :l0, l0:l0 + pb].baddbmm_(
                    torch.bmm(T[:, :l0, :l0], S), Tp, beta=0.0, alpha=-1.0)
        if beyond:
            _larfb(At[:, j0 + jb:, j0:], Vt[:, :jb, :m], T[:, :jb, :jb])
    return At.transpose(1, 2), tau, WB


def _panel_plain(At, tau, T, Vt, WB, p0: int, pb: int, j0: int) -> None:
    """The panel kernel's arithmetic in PyTorch, vectorized over the
    fronts: for each column j, dlarfg from ||x||^2 below the diagonal and
    the sums x' a_k, x' b_c of the update before it (beta =
    -sign(alpha) sqrt(alpha^2 + ||x||^2), then tau and the scale of v from
    one division by beta (alpha - beta)); reflector j applied
    to the later columns and to b; T's column j from V's row j and
    V' v_j; then V written with its unit diagonal and zeros above."""
    P = At[:, p0:p0 + pb, p0:]                # P[:, k, r] = A[p0 + r, p0 + k]
    Bv = None if WB is None else WB[:, p0:, :]
    l0 = p0 - j0
    Tb = T[:, l0:l0 + pb, l0:l0 + pb]
    Tb.zero_()
    for j in range(pb):
        x = P[:, j, j + 1:]
        alpha = P[:, j, j].clone()
        xn2 = (x * x).sum(-1)
        u = (P[:, j + 1:, j + 1:] * x[:, None, :]).sum(-1)
        wb = None if Bv is None else (x[:, :, None] * Bv[:, j + 1:]).sum(1)
        nz = xn2 != 0
        beta = torch.where(nz, -torch.copysign(
            (alpha * alpha + xn2).sqrt(), alpha), alpha)
        d = alpha - beta
        q = 1.0 / torch.where(nz, beta * d, 1.0)
        tj = torch.where(nz, -d * d * q, 0.0)
        scal = torch.where(nz, beta * q, 0.0)
        v = x * scal[:, None]
        td = tj[:, None] * (P[:, j + 1:, j] + u * scal[:, None])
        P[:, j + 1:, j] -= td
        P[:, j + 1:, j + 1:] -= td[:, :, None] * v[:, None, :]
        P[:, j, j] = beta
        P[:, j, j + 1:] = v
        if Bv is not None:
            tdb = tj[:, None] * (Bv[:, j] + wb * scal[:, None])
            Bv[:, j] -= tdb
            Bv[:, j + 1:] -= v[:, :, None] * tdb[:, None, :]
        if j:
            y = P[:, :j, j] + (P[:, :j, j + 1:] * v[:, None, :]).sum(-1)
            Tb[:, :j, j] = -tj[:, None] * torch.bmm(
                Tb[:, :j, :j], y[:, :, None])[:, :, 0]
        Tb[:, j, j] = tj
        tau[:, p0 + j] = tj
    V = P.clone()
    r = torch.arange(P.shape[2], device=P.device)
    k = torch.arange(pb, device=P.device)[:, None]
    V.masked_fill_(r < k, 0.0)
    V[:, k[:, 0], k[:, 0]] = 1.0
    Vt[:, l0:l0 + pb, :l0] = 0.0
    Vt[:, l0:l0 + pb, l0:l0 + P.shape[2]] = V


def _panel_kernel(At, tau, T, Vt, WB, p0: int, pb: int, j0: int,
                  ctr_pool: Optional[torch.Tensor] = None) -> None:
    """One launch of csrc/qr_panel.cu a batch of fronts: all of them where
    a front's rows fit one CTA or a cluster, else as many fronts as the
    card holds at one CTA an SM, with the grid tier's exchange buffer and
    barrier counters (zeroed: front b's of the panel at p0 is
    ``ctr_pool[(p0 // QR_PANEL) * B + b]``)."""
    B, FC, FR = At.shape
    G, rpt = panel_tiling(FR - p0, _sm_count(At.device))
    kb = 0 if WB is None else WB.shape[2]
    per = B if G <= _PANEL_CLUSTER else max(1, _sm_count(At.device) // G)
    for b0 in range(0, B, per):
        nb = min(per, B - b0)
        msg = ctr = None
        if G > _PANEL_CLUSTER:
            msg = At.new_empty(2 * G * nb * _PANEL_MSG)
            ctr = ctr_pool[(p0 // QR_PANEL) * B + b0:]
        cuda_build.launch(
            "sstpu_qr_panel_f64", At, At.data_ptr(), tau.data_ptr(),
            T.data_ptr(), Vt.data_ptr(), WB.data_ptr() if kb else None,
            None if msg is None else msg.data_ptr(),
            None if ctr is None else ctr.data_ptr(), FR, FC, tau.shape[1],
            p0, pb, j0, T.shape[1], nb, b0, G, rpt, kb)
        front_qr.launches += 1


def front_qr_plain(W: torch.Tensor, WB: Optional[torch.Tensor] = None
                   ) -> tuple:
    """Plain PyTorch ``front_qr``: the same panels, T and block reflectors,
    each panel by ``_panel_plain`` (counted in ``launches``)."""
    def panel(*args):
        _panel_plain(*args)
        front_qr_plain.launches += 1
    return _front_qr(W, WB, panel)


front_qr_plain.launches = 0


def front_qr(W: torch.Tensor, WB: Optional[torch.Tensor] = None) -> tuple:
    """Householder QR of a bucket's (B, FR, FC) float64 fronts ``W``, as
    geqrf gives it, and Q'B of their right-hand sides ``WB`` (B, FR, k),
    as ormqr gives it: (QR, tau, QtB).  QR (B, FR, FC) is column-major
    (LAPACK's layout: R on and above the diagonal, the Householder vectors
    below), tau (B, min(FR, FC)); QtB is None without right-hand sides.
    The panels carry up to QR_PANEL_RHS right-hand sides (``WB``, updated
    in place, is then QtB); more are left out of the factorization and
    given Q' by one ormqr from its reflectors, so R never depends on B.

    Stands in for the reference's ``jnp.linalg.qr`` of each bucket
    (suitesparse_tpu/qr/spqr.py:366, ``qr_factorize``'s level loop; no
    Pallas kernel) and for geqrf and ormqr on the card.  What bounds it is
    the fronts' work as ``benchmark/harness/qr_counts.py`` counts it: 2 c^2
    (f - c/3) flops and 2 f (c + 1) entries moved for a front of f rows and
    c columns.  The panels (csrc/qr_panel.cu: reflectors, tau, T and b's
    update, one launch a panel, counted in ``launches``) are latency
    bound; the trailing updates carry the flops as float64 GEMMs on the
    tensor cores, QR_OUTER columns deep.  A CPU tensor takes
    ``front_qr_plain``; a CUDA tensor launches the kernel or raises."""
    if WB is not None and WB.shape[-1] > QR_PANEL_RHS:
        QR, tau, _ = front_qr(W, None)
        return QR, tau, torch.ormqr(QR, tau, WB, left=True, transpose=True)
    if W.device.type == "cpu":
        return front_qr_plain(W, WB)
    if W.device.type != "cuda":
        raise ValueError(f"front_qr: unsupported device {W.device}")
    if W.dtype != torch.float64 or W.dim() != 3:
        raise TypeError(f"front_qr: (B, FR, FC) float64 fronts, got "
                        f"{tuple(W.shape)} {W.dtype}")
    B, FR, FC = W.shape
    if WB is not None and (WB.dtype != W.dtype or WB.device != W.device
                           or tuple(WB.shape[:2]) != (B, FR)
                           or WB.dim() != 3 or not WB.is_contiguous()):
        raise ValueError("front_qr: WB must be a contiguous (B, FR, k) "
                         "float64 tensor beside W")
    tiling = panel_tiling(FR, _sm_count(W.device))
    if tiling is None:
        raise ValueError(f"front_qr: {FR} rows exceed one CTA an SM")
    # the grid tier's barrier counters, every panel's, zeroed once
    pool = None
    if tiling[0] > _PANEL_CLUSTER:
        pool = torch.zeros(-(-min(FR, FC) // QR_PANEL) * B,
                           dtype=torch.int32, device=W.device)
    return _front_qr(W, WB, functools.partial(_panel_kernel, ctr_pool=pool))


# Launches of the kernel: one for each call above, and for each replay of a
# captured device program the number its capture recorded (a replay makes
# no Python call; utils/programs.py adds them)
front_qr.launches = 0


def _qr_levels(S: QRSymbolic, maps: list, av: torch.Tensor,
               bk: Optional[torch.Tensor], Qs: Optional[list] = None):
    """The level loop: (Rbuf, qtb) from the values ``av`` in the factored
    order and the right-hand sides ``bk`` (m, k) or None (qtb is then
    None).  Each bucket's fronts are assembled from A's rows and their
    children's C blocks (one slice of the C buffer, ``_c_layout``), with
    ``bk`` their right-hand sides beside them, then factored -- by
    ``front_qr`` where ``front_qr_takes`` the bucket (real fronts above
    QR_KERNEL_ROWS rows on the card), which carries up to QR_PANEL_RHS
    right-hand sides through its panels, else by one batched geqrf and
    one ormqr -- and their R rows, C blocks and Q'B rows
    scattered out.  The fronts, C blocks and Q'B are in ``front_dtype``;
    Rbuf is in ``av``'s dtype, qtb in the fronts'.  ``Qs`` (a list)
    collects each bucket's complete Q on the device, in ``av``'s dtype."""
    Rbuf = av.new_zeros(S.total_R + 1)
    av = av.to(front_dtype(av.dtype))
    Cbuf = av.new_zeros(S.total_C + 1)
    qtb = None
    if bk is not None:
        k = bk.shape[1]
        bk = bk.to(av.dtype)
        CBbuf = av.new_zeros((S.total_CB + 1, k))
        qtb = av.new_zeros((S.n, k))
    for lv, lmaps in zip(S.levels, maps):
        for bq, mp in zip(lv, lmaps):
            B, FR, FC = len(bq.sids), bq.FR, bq.FC
            W = av.new_zeros(B * FR * FC)
            if "a" in mp:
                src, dst = mp["a"]
                W[dst] = av[src]
            if "c" in mp:
                lo, hi, dst = mp["c"]
                W[dst] = Cbuf[lo:hi]
            W = W.view(B, FR, FC)
            WB = None
            if bk is not None:
                WB = av.new_zeros((B * FR, k))
                src, dst = mp["b"]
                WB[dst] = bk[src]
                if "cb" in mp:
                    src, dst = mp["cb"]
                    WB[dst] = CBbuf[src]
                WB = WB.view(B, FR, k)
            if front_qr_takes(FR, W.dtype, W.device):
                QR, tau, QtB = front_qr(W, WB)
            else:
                QR, tau = torch.geqrf(W)
                QtB = None if WB is None else torch.ormqr(
                    QR, tau, WB, left=True, transpose=True)
            del W
            F = QR.transpose(1, 2).reshape(-1)    # a view when column-major
            src, dst = mp["r"]
            Rbuf[dst] = F[src].to(Rbuf.dtype)
            src, dst = mp["cout"]
            Cbuf[dst] = F[src]
            if Qs is not None:
                Qs.append(_complete_q(QR, tau).to(Rbuf.dtype))
            if QtB is None:
                continue
            QtB = QtB.reshape(-1, k)
            src, dst = mp["cbout"]
            CBbuf[dst] = QtB[src]
            src, dst = mp["qtb"]
            qtb[dst] = QtB[src]
    return Rbuf, qtb


def qr_program(S: QRSymbolic, dtype, device, k: int = 0) -> DeviceProgram:
    """The numeric QR as one device program, cached on the symbolic's plan
    per (dtype, device, k): the values in the factored order (nnz,) in --
    and with k > 0 the right-hand sides (m, k) -- (Rbuf, qtb) out (qtb an
    empty (n, 0) without right-hand sides)."""
    dt = torch_dtype(dtype)
    dev = program_device(device)

    def make():
        maps = _device_plan(S, dev)

        def body(av, bk=None):
            Rbuf, qtb = _qr_levels(S, maps, av, bk)
            return Rbuf, (av.new_zeros((S.n, 0)) if qtb is None else qtb)
        return body

    return cached_program(S.plan._cache, ("qr", dt, dev, int(k)), make, dev,
                          counters=(front_qr,))


def _qr_value_map(S: QRSymbolic, A: SparseCSC) -> PatternMap:
    """The value map of ``A``'s pattern under ``S``, kept in
    ``S.plan._cache`` as a ``PatternMap`` (utils/programs) whose ``vmap``
    says where each value of the factored order (the CSR of A with its
    columns permuted) lies in ``A.data`` and whose ``extra`` holds the
    first entry of each nonempty column of A, reused while A has the
    pattern it was made from.  Made (span ``plan.qr_value_map``)
    by running the old values' chain -- SciPy's column permutation and CSR
    conversion -- on the positions of A's entries, since each step only
    selects and reorders.  Raises SparseError(INVALID) when A's entry
    count is not the symbolic's."""
    def build():
        itype = np.int32 if A.nnz < 2**31 - 1 else np.int64
        # positions from 1: a position 0 would be a stored zero
        pos = SparseCSC(A.indptr, A.indices,
                        np.arange(1, A.nnz + 1, dtype=np.int64),
                        A.shape).to_scipy().tocsc()[:, S.sym.perm].tocsr()
        need = sum(len(bq.a_src) for lv in S.levels for bq in lv)
        if pos.nnz != A.nnz or pos.nnz != need:
            raise SparseError(Status.INVALID,
                              "qr_factorize: the matrix's pattern is not the "
                              "symbolic's")
        nonempty = np.diff(A.indptr) > 0
        return ((pos.data - 1).astype(itype),
                np.asarray(A.indptr[:-1])[nonempty])

    return pattern_map(S.plan._cache, "qr_value_map", A, build,
                       "plan.qr_value_map")


def _default_tol(starts: np.ndarray, data: np.ndarray, m: int, n: int,
                 dtype) -> float:
    """20 (m + n) eps max_j ||A[:, j]||_2 (spqr_tol.cpp), each column's
    squares summed in its stored order, as SciPy's column sum does."""
    sq = np.abs(data) ** 2
    top = (np.add.reduceat(sq, starts).max() if len(starts)
           else np.float64(0.0))
    eps = np.finfo(dtype.type(0).real.dtype).eps
    return 20.0 * (m + n) * eps * max(np.sqrt(top), 1e-300)


@spanned("qr.numeric")
def qr_factorize(A: SparseCSC, S: QRSymbolic, b: Optional[np.ndarray] = None,
                 common: Optional[Common] = None, tol: Optional[float] = None,
                 dtype=None, keep_q: bool = False,
                 device=None) -> QRNumeric:
    """Numeric multifrontal QR on ``device`` (the card when None; raises
    without one); optionally carries B through to give Q'B (the SPQR
    backslash path).  dtype: float64/complex128 on the CPU and
    float32/complex64 on the card unless given.

    keep_q=True retains the per-front complete-mode Q blocks on the host
    so Q can be applied after the fact (qr_qmult / SuiteSparseQR_qmult,
    SPQR/Source/SuiteSparseQR_qmult.cpp) -- the equivalent of returning Q
    in Householder form.

    Spans (utils/trace): ``qr.numeric`` around the call, and inside it
    ``.values`` (A's values, and b, cast in their own order on the host,
    and the default tol), with ``plan.qr_value_map`` inside the first one
    of a pattern, ``.upload`` (h2d), ``.gather`` (the values put in the
    factored order on the device, d2d), ``.program`` (the QR program's
    copy-in, replay and clones, d2d; its first call on a pattern warms up
    and captures it: ``qr_program(S, dtype, device, k)`` holds its
    ``warmup_s``, ``capture_s`` and ``nodes``), ``.check`` (the rank from
    R's diagonal, which waits for the device) and ``.download`` (Q'b's
    rows, d2h).  keep_q runs the same level loop eagerly, not captured."""
    cm = common or default_common()
    cm.checkpoint("qr_factorize")
    dev = resolve_device(device)
    cm.tic("qr_factorize")
    m, n = S.m, S.n
    with span("qr.numeric.values"):
        if A.stype != 0:
            A = SparseCSC.from_scipy(A.to_scipy())
        data = A.data if A.data is not None else np.ones(A.nnz)
        is_complex = np.iscomplexobj(data)
        if dtype is None:
            dtype = default_dtype(dev, is_complex)
        dtype = numpy_dtype(dtype)
        if is_complex and not np.issubdtype(dtype, np.complexfloating):
            dtype = np.dtype(np.complex64 if dtype == np.float32
                             else np.complex128)
        vm = _qr_value_map(S, A)
        host = data.astype(dtype)
        # default tol = 20*(m+n)*eps*max column 2-norm (spqr_tol.cpp)
        if tol is None:
            tol = cm.qr.tol
        if tol is None:
            tol = _default_tol(vm.extra, data, m, n, dtype)
        host_dt = (np.complex128 if np.issubdtype(dtype, np.complexfloating)
                   else np.float64)
        k, bh = 1, None
        if b is not None:
            b = np.asarray(b, dtype=host_dt)
            k = b.reshape(m, -1).shape[1]
            bh = b.reshape(m, k).astype(dtype)
    with span("qr.numeric.upload"):
        va = torch.as_tensor(host, device=dev)
        bk = None if bh is None else torch.as_tensor(bh, device=dev)
        moved("h2d", host.nbytes + (0 if bh is None else bh.nbytes))
    with span("qr.numeric.gather"):
        av = torch.index_select(va, 0, vm.device(dev))
        del va
        moved("d2d", host.nbytes)
    Qs: Optional[list] = None
    with span("qr.numeric.program"):
        if keep_q:
            Qd: list = []
            Rbuf, qtb = _qr_levels(S, _device_plan(S, dev), av, bk, Qd)
            Qs, it = [], iter(Qd)
            for lv in S.levels:
                Qs.append([next(it).cpu().numpy() for _ in lv])
        elif bk is None:
            Rbuf, qtb = qr_program(S, dtype, dev)(av)
            qtb = None
        else:
            Rbuf, qtb = qr_program(S, dtype, dev, k)(av, bk)
    with span("qr.numeric.check"):
        rank = int((np.abs(r_diagonal(S, Rbuf)) > tol).sum())
    with span("qr.numeric.download"):
        if qtb is None:
            qtb_h = np.zeros((n, k), dtype=host_dt)
        else:
            qtb_h = qtb.cpu().numpy().astype(host_dt)
            moved("d2h", qtb.numel() * qtb.element_size())
    cm.status = Status.OK if rank == min(m, n) else Status.SINGULAR
    cm.info.update({"qr_rank": rank, "qr_tol": tol,
                    "qr_time": cm.toc("qr_factorize")})
    return QRNumeric(symbolic=S, Rbuf=Rbuf, qtb=qtb_h, rank=rank, tol=tol,
                     dtype=dtype, Qs=Qs)


def qr_numeric_from_numpy(S: QRSymbolic, Rbuf: np.ndarray, qtb: np.ndarray,
                          rank: int, tol: float, Qs: Optional[list] = None,
                          device=None) -> QRNumeric:
    """A QRNumeric from host arrays: R's flat panel buffer (total_R + 1,
    the reference's layout), Q'b's top rows, the rank and tolerance, and
    optionally the per-front complete Q blocks -- e.g. the reference's own
    factor, so the port's solves and qr_qmult can run on it.  Rbuf goes
    to ``device`` (the card when None; raises without one)."""
    dev = resolve_device(device)
    Rbuf = np.asarray(Rbuf)
    if Rbuf.shape != (S.total_R + 1,):
        raise SparseError(Status.INVALID,
                          f"Rbuf has shape {Rbuf.shape}, the symbolic "
                          f"needs ({S.total_R + 1},)")
    return QRNumeric(symbolic=S, Rbuf=torch.tensor(Rbuf, device=dev),
                     qtb=np.asarray(qtb), rank=int(rank), tol=float(tol),
                     dtype=Rbuf.dtype,
                     Qs=None if Qs is None else [[np.asarray(q) for q in lv]
                                                 for lv in Qs])
# ---------------------------------------------------------------------------
# Applying Q after the fact (SuiteSparseQR_qmult, SPQR qmult methods
# SuiteSparseQR_definitions.h:32-36: QTX / QX / XQT / XQ)
# ---------------------------------------------------------------------------

def _q_out_layout(S: QRSymbolic):
    """Global output-row layout of Q'X.

    The multifrontal orthogonal map sends the m input rows to:
      rows 0..n-1     — R's rows, aligned with the (permuted) columns;
      then per-front residual slots (front rows beyond pivot+carried —
      zero rows of R, the least-squares residual space);
      then passthrough slots for A rows never assembled (structurally
      zero rows of A, on which Q acts as identity).
    Fronts with fewer rows than pivotal columns leave their dead pivotal
    slots structurally zero, so the map is an isometry R^m -> R^{n_out}
    with n_out >= m (n_out == m when every pivotal slot is populated).
    Returns (out_dst per level/bucket (B, FR) with -1 = carried/pad row,
    n_out, passthrough_rows).
    """
    cached = getattr(S, "_q_layout", None)
    if cached is not None:
        return cached
    n = S.n
    res_base = n
    out_maps = []
    assembled = []
    for lv in S.levels:
        row = []
        for bq in lv:
            B, FR = len(bq.sids), bq.FR
            od = np.full((B, FR), -1, dtype=INDEX)
            for b in range(B):
                fr = int(bq.fr[b])
                ns_b = int(bq.ns[b])
                npiv = min(ns_b, fr)
                od[b, :npiv] = bq.colidx[b, :npiv]
                ncarry = int((bq.cb_out_dst[b] < S.total_CB).sum())
                nres = max(0, fr - ns_b - ncarry)
                if nres:
                    od[b, ns_b + ncarry:fr] = res_base + np.arange(nres)
                    res_base += nres
            row.append(od)
        out_maps.append(row)
    for rows in S.arow_of_front:
        assembled.append(rows)
    assembled = (np.concatenate(assembled) if assembled
                 else np.empty(0, dtype=INDEX))
    passthrough = np.setdiff1d(np.arange(S.m, dtype=INDEX), assembled)
    n_out = res_base + len(passthrough)
    S._q_layout = (out_maps, int(n_out), passthrough)
    return S._q_layout


def qr_qmult(num: QRNumeric, X: np.ndarray, method: str = "QTX") -> np.ndarray:
    """Apply the orthogonal factor: Q'X, QX, XQ', or XQ
    (SuiteSparseQR_qmult; requires qr_factorize(..., keep_q=True)).

    Q'X maps (m, k) -> (n_out, k) in the _q_out_layout row order;
    QX maps (n_out, k) -> (m, k).  qmult(QX, qmult(QTX, X)) == X.
    """
    if num.Qs is None:
        raise SparseError(Status.INVALID,
                          "qr_qmult needs qr_factorize(..., keep_q=True)")
    if method == "XQT":      # X Q^H = (Q X^H)^H
        return np.conj(qr_qmult(num, np.conj(np.asarray(X)).T, "QX")).T
    if method == "XQ":       # X Q = (Q^H X^H)^H
        return np.conj(qr_qmult(num, np.conj(np.asarray(X)).T, "QTX")).T
    if method not in ("QTX", "QX"):
        raise ValueError(f"unknown qmult method {method!r}")
    S = num.symbolic
    out_maps, n_out, passthrough = _q_out_layout(S)
    dt = np.result_type(np.asarray(X).dtype, num.dtype, np.float64)
    X = np.asarray(X, dtype=dt)
    one_d = X.ndim == 1
    Xk = X.reshape(X.shape[0], -1)
    k = Xk.shape[1]
    CB = np.zeros((S.total_CB + 1, k), dtype=dt)

    if method == "QTX":
        if Xk.shape[0] != S.m:
            raise ValueError(f"QTX expects {S.m} rows, got {Xk.shape[0]}")
        Y = np.zeros((n_out, k), dtype=dt)
        if len(passthrough):
            Y[n_out - len(passthrough):] = Xk[passthrough]
        for li, lv in enumerate(S.levels):
            for bi, bq in enumerate(lv):
                B, FR = len(bq.sids), bq.FR
                Q = num.Qs[li][bi]
                FB = np.zeros((B * FR, k), dtype=dt)
                br = bq.b_rows.reshape(-1)
                ok = br >= 0
                FB[np.where(ok)[0]] = Xk[br[ok]]
                if len(bq.c_brow_src):
                    FB[bq.c_brow_dst] = CB[bq.c_brow_src]
                QtB = np.einsum("brm,brk->bmk", np.conj(Q.astype(dt)),
                                FB.reshape(B, FR, k))
                flat = QtB.reshape(B * FR, k)
                # invalid slots point at the trash row (== total_CB)
                CB[bq.cb_out_dst.reshape(-1)] = flat
                od = out_maps[li][bi].reshape(-1)
                ok2 = od >= 0
                Y[od[ok2]] = flat[ok2]
        return Y[:, 0] if one_d else Y

    # QX: reverse replay, root first
    if Xk.shape[0] != n_out:
        raise ValueError(f"QX expects {n_out} rows, got {Xk.shape[0]}")
    Y = np.zeros((S.m, k), dtype=dt)
    if len(passthrough):
        Y[passthrough] = Xk[n_out - len(passthrough):]
    for li in range(len(S.levels) - 1, -1, -1):
        for bi, bq in enumerate(S.levels[li]):
            B, FR = len(bq.sids), bq.FR
            Q = num.Qs[li][bi]
            OutB = np.zeros((B * FR, k), dtype=dt)
            od = out_maps[li][bi].reshape(-1)
            ok2 = od >= 0
            OutB[ok2] = Xk[od[ok2]]
            cbd = bq.cb_out_dst.reshape(-1)
            okc = cbd < S.total_CB
            OutB[okc] = CB[cbd[okc]]
            BQ = np.einsum("brm,bmk->brk", Q.astype(dt),
                           OutB.reshape(B, FR, k))
            flat = BQ.reshape(B * FR, k)
            br = bq.b_rows.reshape(-1)
            ok = br >= 0
            Y[br[ok]] = flat[np.where(ok)[0]]
            if len(bq.c_brow_src):
                CB[bq.c_brow_src] = flat[bq.c_brow_dst]
    return Y[:, 0] if one_d else Y


def qr_q(num: QRNumeric, econ: bool = True) -> np.ndarray:
    """Explicit dense orthogonal factor (SuiteSparseQR's 'output Q as a
    sparse matrix' option; dense here — intended for modest m).  econ=True
    returns the first n columns (A[:,E] = Q_econ @ R)."""
    S = num.symbolic
    Qt = qr_qmult(num, np.eye(S.m), "QTX")     # (n_out, m) = Q^H
    Q = np.conj(Qt).T
    return Q[:, :S.n] if econ and S.n <= Q.shape[1] else Q


def _bind_r(num: QRNumeric):
    """Make ``num``'s R the factor that the R-solve programs of its
    symbolic's plan read (``super_numeric.SolveFactor``, one per route,
    dtype and device), through ``Binding.load`` in the span
    ``qr.solve.bind``: R's panels (R^T in the Cholesky factor's layout),
    and on the wave route their inverted diagonal blocks.  A dead pivot
    (|diag| <= tol) gets the unit row in R, so that with a zero right-hand
    side entry its unknown is 0 -- the basic solution's convention.  Only
    another numeric, or new values, are copied in.  Returns the dead
    pivots."""
    S = num.symbolic
    plan = S.plan
    wave = plan.use_wave()
    dev = num.Rbuf.device
    R = _solve_factor(plan, wave, num.Rbuf.dtype, dev, None)
    dead = np.zeros(0, dtype=np.int64)
    if num.rank < S.n:
        dead = np.nonzero(np.abs(r_diagonal(S, num.Rbuf)) <= num.tol)[0]

    def sources():
        src = num.Rbuf[:plan.total]
        if len(dead):
            ss = S.ss
            s = ss.col_to_super[dead].astype(np.int64)
            t = dead - ss.super[s]
            o, Np = ss.panel_off[s], ss.panel_Np[s]
            g, r = _ragged(ss.panel_Mp[s])
            src = src.clone()
            src[_index(o[g] + r * Np[g] + t[g], dev)] = 0
            src[_index(o + t * (Np + 1), dev)] = 1
        yield src
        if wave:
            yield R.dinv()      # from the panels just copied in

    R.bound.load("qr.solve.bind", num, (num.Rbuf,), sources)
    return dead


@spanned("qr.solve")
def qr_rsolve(num: QRNumeric, c: np.ndarray, dead_zero: bool = True) -> np.ndarray:
    """x = R \\ c in the permuted column space; dead columns get x=0
    (SPQR basic solution convention).

    Runs on the device of R through the plan's "Lt" solve program
    (``super_numeric.solve_program``: R x = c is L^T x = c for L = R^T,
    which R's panels hold), in R's dtype.  Spans (utils/trace):
    ``qr.solve`` around the call, and inside it ``.bind`` (where
    ``_bind_r`` copies a numeric in), ``.upload`` (c, h2d), ``.program``
    (copy-in, replay, clone) and ``.download`` (x, d2h)."""
    S = num.symbolic
    n = S.n
    dt = np.result_type(num.dtype, np.float64)
    x = np.array(c, dtype=dt, copy=True)
    one_d = x.ndim == 1
    xk = x.reshape(n, -1)
    xk[_bind_r(num)] = 0
    dev = num.Rbuf.device
    prog = solve_program(S.plan, "Lt", xk.shape[1], num.Rbuf.dtype, dev)
    with span("qr.solve.upload"):
        ct = torch.as_tensor(xk, device=dev).to(num.Rbuf.dtype)
        moved("h2d", xk.nbytes)
    with span("qr.solve.program"):
        xt = prog(ct)
    with span("qr.solve.download"):
        out = xt.cpu().numpy().astype(dt)
        moved("d2h", out.nbytes)
    return out.reshape(-1) if one_d else out


def qr_rtsolve(num: QRNumeric, c: np.ndarray) -> np.ndarray:
    """y = R^H \\ c (forward substitution on the adjoint of the upper
    factor, in the permuted column space); dead columns (|diag| <= tol)
    get y=0 — the spqr_rsolve transpose path used by min2norm."""
    S = num.symbolic
    ss = S.ss
    n = S.n
    h = num.Rbuf.cpu().numpy()
    dt = np.result_type(h.dtype, np.float64)
    x = np.array(c, dtype=dt, copy=True)
    one_d = x.ndim == 1
    xk = x.reshape(n, -1)
    import scipy.linalg as sla
    for s in range(ss.nsuper):
        ms, ns_ = ss.panel_shape(s)
        Np, Mp = int(ss.panel_Np[s]), int(ss.panel_Mp[s])
        o = int(ss.panel_off[s])
        # panels store R^T; conjugate gives R^H blocks
        pn = np.conj(h[o:o + Mp * Np].reshape(Mp, Np).astype(dt))
        j1 = int(ss.super[s])
        beyond = ss.rows_of(s)[ns_:]
        R11h = pn[:ns_, :ns_].copy()          # R11^H, lower triangular
        rhs = xk[j1:j1 + ns_].copy()
        d = np.diag(R11h)
        dead = np.abs(d) <= num.tol
        if dead.any():
            R11h[dead, :] = 0.0
            R11h[:, dead] = 0.0
            R11h[dead, dead] = 1.0
            rhs[dead] = 0.0
        y = sla.solve_triangular(R11h, rhs, lower=True)
        xk[j1:j1 + ns_] = y
        if len(beyond):
            R12h = pn[Np:Np + (ms - ns_), :ns_]   # (R^H) rows beyond cols
            xk[beyond] -= R12h @ y
    return x.reshape(-1) if one_d else xk


def _r_coo(num: QRNumeric) -> tuple:
    """(rows, columns, values) of R's nonzero entries on the host, sorted
    by column and then row, expanded and gathered on R's device: the
    panel row r (supernode s's r-th row, normalized) and column t hold
    R[j1 + t, rows_s[r]] for t <= r."""
    S, dev = num.symbolic, num.Rbuf.device
    ss = S.ss
    sup = ss.super.astype(np.int64)
    ns = np.diff(sup)
    s, r = _ragged(np.diff(ss.sn_rowptr))
    prow = np.where(r < ns[s], r, ss.panel_Np[s] + r - ns[s])
    ix = lambda a: _index(a, dev)  # noqa: E731
    seg, t = _runs(ix(np.minimum(r + 1, ns[s])))
    pos = ix(ss.panel_off[s] + prow * ss.panel_Np[s])[seg] + t
    vals = num.Rbuf[pos]
    rows = ix(sup[s])[seg] + t
    cols = ix(ss.sn_rows)[seg]
    nz = vals != 0
    rows, cols, vals = rows[nz], cols[nz], vals[nz]
    order = torch.argsort(cols * S.n + rows)
    return tuple(a[order].cpu().numpy() for a in (rows, cols, vals))


def _r_matrix(num: QRNumeric):
    """R (n x n, upper triangular, permuted column order) as a host scipy
    CSR matrix, read out of the panel buffer."""
    return qr_get_r(num).tocsr()


def qr_get_r(num: QRNumeric):
    """R as a SciPy CSC matrix of its nonzero entries (n x n, upper
    triangular), whose column j is column ``num.symbolic.sym.perm[j]`` of
    A: A P = Q R."""
    import scipy.sparse as sp
    n = num.symbolic.n
    rows, cols, vals = _r_coo(num)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols, minlength=n), out=indptr[1:])
    return sp.csc_matrix((vals, rows, indptr), shape=(n, n))


def _basic_solve(num: QRNumeric, c: np.ndarray,
                 adjoint: bool = False) -> np.ndarray:
    """The least-squares solution over R's live pivots: x = R \\ c
    (adjoint: R^H \\ c) with the dead entries 0 and the live ones
    minimizing ||R[:, live] x_l - c|| (adjoint: ||R^H[:, live] x_l - c||)
    over every row, the dead rows included.

    qr_rsolve/qr_rtsolve alone drop the dead rows' equations, which is
    the least-squares solution only when those rows of R (columns, for
    the adjoint) are zero beside the diagonal: true of a structural rank
    deficiency and of a dead last pivot, not of a column that depends
    numerically on earlier ones (its Householder step reflects rounding
    noise, and the row it leaves is not small).  The dead rows D enter
    as a rank-k correction (Woodbury, k = number of dead pivots):
    x = x0 + R_ll^-1 U (I + U^H U)^-1 (c_d - D x0), U = R_ll^-H D^H --
    the reference's result when D = 0, the true least-squares one
    otherwise.  Full rank costs nothing."""
    fwd, back = (qr_rtsolve, qr_rsolve) if adjoint else (qr_rsolve,
                                                         qr_rtsolve)
    x0 = np.asarray(fwd(num, c))
    dead = np.nonzero(np.abs(r_diagonal(num.symbolic, num.Rbuf))
                      <= num.tol)[0]
    if len(dead) == 0:
        return x0
    R = _r_matrix(num)
    D = (R[:, dead].conj().T if adjoint else R[dead, :]).toarray()
    one_d = x0.ndim == 1
    xk = x0.reshape(x0.shape[0], -1)
    ck = np.asarray(c).reshape(xk.shape[0], -1)
    U = np.asarray(back(num, D.conj().T))  # (n, k), zero on dead rows
    r = ck[dead] - D @ xk
    G = np.eye(len(dead)) + U.conj().T @ U
    x = xk + np.asarray(fwd(num, U @ np.linalg.solve(G, r)))
    return x[:, 0] if one_d else x


def qr_min2norm(A: SparseCSC, b: np.ndarray,
                common: Optional[Common] = None,
                tol: Optional[float] = None, device=None) -> np.ndarray:
    """Minimum 2-norm solution of an underdetermined system Ax=b (m < n):
    QR of A^H (SuiteSparseQR_min2norm) — A^H P = Q R, so A = P' R^H Q^H
    and x = Q (R^{-H} P'b) lies in A's row space."""
    cm = common or default_common()
    device = resolve_device(device)
    m, n = A.shape
    Af = A.to_full_storage() if A.stype != 0 else A
    At = Af.transpose(values=True, conjugate=True)
    S = qr_symbolic(At, cm)
    num = qr_factorize(At, S, common=cm, tol=tol, keep_q=True,
                       device=device)
    dt = np.result_type(num.dtype, np.float64)
    b = np.asarray(b, dtype=dt)
    one_d = b.ndim == 1
    bk = b.reshape(m, -1)
    z = _basic_solve(num, bk[S.sym.perm], adjoint=True)   # R^H z = P' b
    _, n_out, _ = _q_out_layout(S)
    zfull = np.zeros((n_out, bk.shape[1]), dtype=dt)
    zfull[:m] = z                              # pivotal slots = rows of R
    x = qr_qmult(num, zfull, "QX")
    return x[:, 0] if one_d else x


def qr_solve(A: SparseCSC, b: np.ndarray,
             common: Optional[Common] = None,
             tol: Optional[float] = None, device=None) -> np.ndarray:
    """SuiteSparseQR-style backslash: least squares min ||Ax - b||_2 for
    m >= n (rank-deficient A gets the basic solution, dead columns zeroed);
    minimum 2-norm solution via QR of A' for m < n
    (SPQR/Source/SuiteSparseQR.cpp backslash dispatch)."""
    cm = common or default_common()
    device = resolve_device(device)
    m, n = A.shape
    if m < n:
        return qr_min2norm(A, b, common=cm, tol=tol, device=device)
    S = qr_symbolic(A, cm)
    num = qr_factorize(A, S, b=b, common=cm, tol=tol, device=device)
    xq = _basic_solve(num, num.qtb if np.asarray(b).ndim > 1
                      else num.qtb[:, 0])
    x = np.empty_like(xq)
    x[S.sym.perm] = xq
    return x
