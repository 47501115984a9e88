"""SPQR-class multifrontal sparse QR in PyTorch (CPU or CUDA).

Counterpart of suitesparse_tpu/qr/spqr.py.  Reference behavior targeted
(SPQR): symbolic analysis = supernodal analysis of A'A (spqr_analyze.cpp
uses cholmod_analyze_p2); numeric = per-front dense Householder QR with
child contribution blocks assembled in staircase form (spqr_front.cpp);
rank detection with tol = 20*(m+n)*eps*max column 2-norm
(SuiteSparseQR_definitions.h:28, spqr_tol.cpp); least-squares solve via
Q'b carried through the factorization + R backsolve (SuiteSparseQR<Entry>).

The host side -- the analysis, the padded shape buckets of each
elimination-tree level, the static staircase-assembly maps, the Q'X output
layout and the per-supernode R solves -- is the reference's, copied, so
the symbolic objects are identical.  The level loop is plain PyTorch on an
explicit device: one batched torch.linalg.qr per bucket (LAPACK on the
CPU, cuSOLVER/MAGMA on the card), every assembly and output scatter a
non-atomic indexed write through the cached sorted, unique maps, so two
refactorizations on the card are bit-identical.  Two differences from the
reference, with the same results: Q'b's top rows stay on the device and
are copied to the host once, and R's diagonal is gathered through one
precomputed index vector instead of copying the whole R buffer.  When
neither b nor keep_q is asked, Q is not formed (mode="r": the same geqrf
R as the reduced mode).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, SYM_UPPER
from ..core.status import SparseError, Status
from ..cholesky.supernodal import SuperSymbolic, super_symbolic, _pad_dim
from ..cholesky.symbolic import Symbolic, analyze
from ..cholesky.super_numeric import _index, sorted_scatter_maps
from ..utils.device import (default_dtype, numpy_dtype, resolve_device,
                            torch_dtype)


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


@dataclasses.dataclass
class _QRBucket:
    sids: np.ndarray
    FR: int                   # padded front rows
    FC: int                   # padded front cols
    Np: int                   # padded pivotal column count
    # assembly maps (flat indices into the level workspace of this bucket)
    a_src: np.ndarray         # indices into the A-value vector
    a_dst: np.ndarray         # -> workspace flat positions
    c_src: np.ndarray         # indices into the C buffer
    c_dst: np.ndarray
    b_rows: np.ndarray        # (B, FR) original A-row id carried into front
                              # rows (for stacking B), -1 = child/pad row
    c_brow_src: np.ndarray    # C carried-B buffer sources (flat)
    c_brow_dst: np.ndarray    # -> (b, front_row) flattened positions
    # outputs
    r_dst: np.ndarray         # (B, FC, Np): workspace R rows -> R panel flat
    c_out_dst: np.ndarray     # (B, FR, FC): C-block rows -> C buffer flat
    cb_out_dst: np.ndarray    # (B, FR): C-rows -> carried-B buffer row (+1-based? -1 pad)
    colidx: np.ndarray        # (B, Np) global pivotal columns (n = pad)
    rowidx: np.ndarray        # (B, FCmNp) global beyond cols (n = pad)
    ns: np.ndarray            # (B,) true pivotal widths
    fr: np.ndarray            # (B,) true front row counts
    # cached sorted scatter maps (built lazily by _sorted_pair/_sorted_drop;
    # declared so slots=True/frozen variants would not silently break them)
    _a_maps: tuple = None
    _c_maps: tuple = None
    _cb_maps: tuple = None
    _r_maps: tuple = None
    _cout_maps: tuple = None
    _cbout_maps: tuple = None


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


def qr_symbolic(A: SparseCSC, common: Optional[Common] = None) -> QRSymbolic:
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

    p = sym.perm                      # column ordering
    Ap = SparseCSC.from_scipy(S[:, p].tocsc())   # A with permuted cols
    # leftmost column (in permuted order) of each row
    ApT = Ap.to_scipy().tocsr()
    leftmost = np.full(m, -1, dtype=INDEX)
    for i in range(m):
        lo, hi = ApT.indptr[i], ApT.indptr[i + 1]
        if hi > lo:
            leftmost[i] = ApT.indices[lo:hi].min()
    rows_list = [ss.rows_of(s) for s in range(ss.nsuper)]
    arow_of_front: list[np.ndarray] = []
    for s in range(ss.nsuper):
        j1, j2 = int(ss.super[s]), int(ss.super[s + 1])
        sel = np.where((leftmost >= j1) & (leftmost < j2))[0]
        arow_of_front.append(sel.astype(INDEX))

    # bottom-up front row counts and C-block sizes
    nsuper = ss.nsuper
    crows = np.zeros(nsuper, dtype=INDEX)
    frows = np.zeros(nsuper, dtype=INDEX)
    children: list[list[int]] = [[] for _ in range(nsuper)]
    for s in range(nsuper):
        pnt = int(ss.sn_parent[s])
        if pnt != -1:
            children[pnt].append(s)
    for s in range(nsuper):           # postorder: children first (s ascending)
        ms, ns = ss.panel_shape(s)
        fr = len(arow_of_front[s]) + sum(int(crows[c]) for c in children[s])
        frows[s] = fr
        ccols = ms - ns
        crows[s] = max(0, min(fr - ns, ccols)) if ccols > 0 else 0

    c_off = np.zeros(nsuper + 1, dtype=INDEX)
    np.cumsum([int(crows[s]) * (ss.panel_shape(s)[0] - ss.panel_shape(s)[1])
               for s in range(nsuper)], out=c_off[1:])
    cb_off = np.zeros(nsuper + 1, dtype=INDEX)
    np.cumsum(crows, out=cb_off[1:])

    # buckets per level
    Ap_csc = Ap
    levels_out = []
    for level in ss.levels:
        groups: dict[tuple, list[int]] = {}
        for s in level.tolist():
            ms, ns = ss.panel_shape(s)
            key = (_pad_dim(max(int(frows[s]), 1)), _pad_dim(ms), _pad_dim(ns))
            groups.setdefault(key, []).append(s)
        buckets = []
        for (FR, FC, Np), sids in sorted(groups.items()):
            B = len(sids)
            a_src, a_dst, c_src, c_dst = [], [], [], []
            cb_src, cb_dst = [], []
            b_rows = np.full((B, FR), -1, dtype=INDEX)
            r_dst = np.full((B, FC, Np), ss.total, dtype=INDEX)
            c_out_dst = np.full((B, FR, FC), int(c_off[-1]), dtype=INDEX)
            cb_out_dst = np.full((B, FR), int(cb_off[-1]), dtype=INDEX)
            colidx = np.full((B, Np), n, dtype=INDEX)
            rowidx = np.full((B, FC), n, dtype=INDEX)
            ns_arr = np.zeros(B, dtype=INDEX)
            fr_arr = np.zeros(B, dtype=INDEX)
            for b, s in enumerate(sids):
                ms, ns = ss.panel_shape(s)
                j1 = int(ss.super[s])
                rows_s = rows_list[s]
                ns_arr[b] = ns
                fr_arr[b] = int(frows[s])
                colidx[b, :ns] = j1 + np.arange(ns)
                beyond = rows_s[ns:]
                rowidx[b, :ms - ns] = beyond
                colpos = {int(c): k for k, c in enumerate(rows_s)}
                base = b * FR * FC
                # A rows stack first (entry maps built in the pass below)
                for rofs, r in enumerate(arow_of_front[s]):
                    b_rows[b, rofs] = r
                # children C blocks
                crofs = len(arow_of_front[s])
                for c in children[s]:
                    ccols_c = ss.panel_shape(c)[0] - ss.panel_shape(c)[1]
                    rows_c_beyond = rows_list[c][ss.panel_shape(c)[1]:]
                    colmap = np.array([colpos[int(x)] for x in rows_c_beyond],
                                      dtype=INDEX)
                    for rr in range(int(crows[c])):
                        srcrow = int(c_off[c]) + rr * ccols_c
                        dstrow = base + (crofs + rr) * FC
                        c_src.extend(range(srcrow, srcrow + ccols_c))
                        c_dst.extend((dstrow + colmap).tolist())
                        cb_src.append(int(cb_off[c]) + rr)
                        cb_dst.append(b * FR + crofs + rr)
                    crofs += int(crows[c])
                # R output: workspace row t (t < min(fr, ms)) col k ->
                # R panel (padded normalized layout): Rpanel[norm(k), t]
                o = int(ss.panel_off[s])
                NpS = int(ss.panel_Np[s])
                for t in range(min(int(frows[s]), ms, ns)):
                    for k in range(t, ms):
                        nk = k if k < ns else NpS + (k - ns)
                        r_dst[b, k, t] = o + nk * NpS + t
                # C out: workspace rows ns..ns+crows, cols ns.. -> C buffer
                ccols_s = ms - ns
                for rr in range(int(crows[s])):
                    for k in range(ccols_s):
                        c_out_dst[b, ns + rr, ns + k] = (int(c_off[s])
                                                         + rr * ccols_s + k)
                    cb_out_dst[b, ns + rr] = int(cb_off[s]) + rr
            # A entry maps (vectorized per bucket using the CSR)
            for b, s in enumerate(sids):
                rows_s = rows_list[s]
                colpos = {int(c): k for k, c in enumerate(rows_s)}
                base = b * FR * FC
                for rofs, r in enumerate(arow_of_front[s]):
                    lo, hi = int(ApT.indptr[r]), int(ApT.indptr[r + 1])
                    for t in range(lo, hi):
                        cpos = colpos[int(ApT.indices[t])]
                        a_src.append(t)
                        a_dst.append(base + rofs * FC + cpos)
            buckets.append(_QRBucket(
                sids=np.array(sids, dtype=INDEX), FR=FR, FC=FC, Np=Np,
                a_src=np.array(a_src, dtype=INDEX),
                a_dst=np.array(a_dst, dtype=INDEX),
                c_src=np.array(c_src, dtype=INDEX),
                c_dst=np.array(c_dst, dtype=INDEX),
                b_rows=b_rows,
                c_brow_src=np.array(cb_src, dtype=INDEX),
                c_brow_dst=np.array(cb_dst, dtype=INDEX),
                r_dst=r_dst, c_out_dst=c_out_dst, cb_out_dst=cb_out_dst,
                colidx=colidx, rowidx=rowidx, ns=ns_arr, fr=fr_arr))
        levels_out.append(buckets)
    return QRSymbolic(m=m, n=n, sym=sym, ss=ss, levels=levels_out,
                      total_R=ss.total, total_C=int(c_off[-1]),
                      c_off=c_off, cb_off=cb_off, total_CB=int(cb_off[-1]),
                      arow_of_front=arow_of_front)



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


def _bucket_maps(S: QRSymbolic, bq: _QRBucket, complete: bool) -> dict:
    """Host index maps of one bucket's level step, as gathers straight out
    of the front QR's R (B, mn, FC) and Q'B (B, mn, k), mn = FR in the
    complete mode and min(FR, FC) otherwise.  They are the reference's
    sorted maps (_sorted_pair/_sorted_drop) with the source positions
    moved from the padded, transposed R^T (B, FC, Np), the zero-padded
    (B, FR, FC) front and the zero-padded (B*FR) carried rows into R and
    Q'B themselves: every target is one the reference writes, every value
    the same, and no padded copy is made."""
    B, FR, FC, Np = len(bq.sids), bq.FR, bq.FC, bq.Np
    mn = FR if complete else min(FR, FC)
    out = {}
    if len(bq.a_src):
        out["a"] = _sorted_pair(bq, "_a_maps", bq.a_src, bq.a_dst)
    if len(bq.c_src):
        out["c"] = _sorted_pair(bq, "_c_maps", bq.c_src, bq.c_dst)
    br = bq.b_rows.reshape(-1)
    ok = np.nonzero(br >= 0)[0]
    out["b"] = (br[ok].astype(INDEX), ok.astype(INDEX))
    if len(bq.c_brow_src):
        out["cb"] = _sorted_pair(bq, "_cb_maps", bq.c_brow_src,
                                 bq.c_brow_dst)
    # R rows -> R panels: Rt[b, k, t] = R[b, t, k]
    rsrc, rdst = _sorted_drop(bq, "_r_maps", bq.r_dst, S.total_R)
    b, k, t = np.unravel_index(rsrc, (B, FC, Np))
    assert np.all(t < mn), "R panel row beyond the front's R"
    out["r"] = (((b * mn + t) * FC + k).astype(INDEX), rdst)
    # C block -> C buffer: Rfull[b, r, c] = R[b, r, c] for r < mn
    osrc, odst = _sorted_drop(bq, "_cout_maps", bq.c_out_dst, S.total_C)
    b, r, c = np.unravel_index(osrc, (B, FR, FC))
    assert np.all(r < mn), "C block row beyond the front's R"
    out["cout"] = (((b * mn + r) * FC + c).astype(INDEX), odst)
    # carried rows of Q'B -> carried-B buffer
    bsrc, bdst = _sorted_drop(bq, "_cbout_maps", bq.cb_out_dst, S.total_CB)
    b, r = np.unravel_index(bsrc, (B, FR))
    assert np.all(r < mn), "carried row beyond the front's Q'B"
    out["cbout"] = ((b * mn + r).astype(INDEX), bdst)
    # Q'b's top rows -> qtb rows (the pivotal columns; unique over fronts)
    take = np.minimum(bq.ns, mn)
    qsrc = np.concatenate([bi * mn + np.arange(take[bi])
                           for bi in range(B)]).astype(INDEX)
    qdst = np.concatenate([bq.colidx[bi, :take[bi]]
                           for bi in range(B)]).astype(INDEX)
    out["qtb"] = (qsrc, qdst)
    return out


def _diag_index(S: QRSymbolic) -> np.ndarray:
    """Flat positions of R's diagonal in the panel buffer, in column
    order (the reference reads np.diag of each supernode's panel)."""
    ss = S.ss
    return np.concatenate(
        [int(ss.panel_off[s]) + np.arange(ss.panel_shape(s)[1])
         * (int(ss.panel_Np[s]) + 1) for s in range(ss.nsuper)]
        + [np.zeros(0, dtype=np.int64)]).astype(INDEX)


def _device_plan(S: QRSymbolic, dev: torch.device, complete: bool) -> dict:
    """Device copies of every bucket's maps, cached on the symbolic per
    device and mode."""
    cache = S.__dict__.setdefault("_device_plans", {})
    key = (dev, complete)
    got = cache.get(key)
    if got is None:
        levels = []
        for lv in S.levels:
            levels.append([{name: (_index(src, dev), _index(dst, dev))
                            for name, (src, dst) in
                            _bucket_maps(S, bq, complete).items()}
                           for bq in lv])
        got = cache[key] = levels
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
    in Householder form."""
    cm = common or default_common()
    cm.checkpoint("qr_factorize")
    dev = resolve_device(device)
    cm.tic("qr_factorize")
    m, n = S.m, S.n
    Sc = A.to_scipy().tocsc()[:, S.sym.perm]
    ApT = Sc.tocsr()
    is_complex_data = np.iscomplexobj(ApT.data)
    if dtype is None:
        dtype = default_dtype(dev, is_complex_data)
    dtype = numpy_dtype(dtype)
    if is_complex_data and not np.issubdtype(dtype, np.complexfloating):
        dtype = np.dtype(np.complex64 if dtype == np.float32
                         else np.complex128)
    tdt = torch_dtype(dtype)
    avals = torch.as_tensor(ApT.data.astype(dtype), device=dev)

    is_complex = np.issubdtype(dtype, np.complexfloating)
    # default tol = 20*(m+n)*eps*max column 2-norm (spqr_tol.cpp)
    if tol is None:
        tol = cm.qr.tol
    if tol is None:
        colnorm = np.sqrt(np.asarray(abs(Sc).power(2).sum(axis=0)).ravel())
        eps = np.finfo(dtype.type(0).real.dtype).eps
        tol = 20.0 * (m + n) * eps * max(colnorm.max(initial=0.0), 1e-300)

    k = 1
    host_dt = np.complex128 if is_complex else np.float64
    bk = None
    if b is not None:
        b = np.asarray(b, dtype=host_dt)
        k = b.reshape(m, -1).shape[1]
        bk = torch.as_tensor(b.reshape(m, k).astype(dtype), device=dev)

    plan = _device_plan(S, dev, keep_q)
    Rbuf = torch.zeros(S.total_R + 1, dtype=tdt, device=dev)
    Cbuf = torch.zeros(S.total_C + 1, dtype=tdt, device=dev)
    if bk is not None:
        CBbuf = torch.zeros((S.total_CB + 1, k), dtype=tdt, device=dev)
        qtb = torch.zeros((n, k), dtype=tdt, device=dev)
    Qs: Optional[list] = [] if keep_q else None
    # Q is needed only to carry B or to keep it: otherwise mode "r" gives
    # the same geqrf R without forming Q (nothing reads the zero Q'B)
    mode = "complete" if keep_q else ("reduced" if bk is not None else "r")

    for lv, maps in zip(S.levels, plan):
        if keep_q:
            Qs.append([])
        for bq, mp in zip(lv, maps):
            B = len(bq.sids)
            W = torch.zeros(B * bq.FR * bq.FC, dtype=tdt, device=dev)
            if "a" in mp:
                src, dst = mp["a"]
                W[dst] = avals[src]
            if "c" in mp:
                src, dst = mp["c"]
                W[dst] = Cbuf[src]
            Q, R = torch.linalg.qr(W.view(B, bq.FR, bq.FC), mode=mode)
            if keep_q:
                Qs[-1].append(Q.cpu().numpy())          # (B, FR, FR)
            Rf = R.reshape(-1)
            src, dst = mp["r"]
            Rbuf[dst] = Rf[src]
            src, dst = mp["cout"]
            Cbuf[dst] = Rf[src]
            if bk is None:
                continue
            # carried B block
            WB = torch.zeros((B * bq.FR, k), dtype=tdt, device=dev)
            src, dst = mp["b"]
            WB[dst] = bk[src]
            if "cb" in mp:
                src, dst = mp["cb"]
                WB[dst] = CBbuf[src]
            QtB = (Q.mH @ WB.view(B, bq.FR, k)).reshape(-1, k)
            src, dst = mp["cbout"]
            CBbuf[dst] = QtB[src]
            src, dst = mp["qtb"]
            qtb[dst] = QtB[src]
    # rank from |diag(R)|
    rank = int((np.abs(r_diagonal(S, Rbuf)) > tol).sum())
    qtb_h = (qtb.cpu().numpy().astype(host_dt) if bk is not None
             else np.zeros((n, k), dtype=host_dt))
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


def qr_rsolve(num: QRNumeric, c: np.ndarray, dead_zero: bool = True) -> np.ndarray:
    """x = R \\ c in the permuted column space; dead columns get x=0
    (SPQR basic solution convention)."""
    S = num.symbolic
    ss = S.ss
    n = S.n
    h = num.Rbuf.cpu().numpy()
    dt = np.result_type(h.dtype, np.float64)
    x = np.array(c, dtype=dt, copy=True)
    one_d = x.ndim == 1
    xk = x.reshape(n, -1)
    for s in range(ss.nsuper - 1, -1, -1):
        ms, ns_ = ss.panel_shape(s)
        Np, Mp = int(ss.panel_Np[s]), int(ss.panel_Mp[s])
        o = int(ss.panel_off[s])
        pn = h[o:o + Mp * Np].reshape(Mp, Np).astype(dt)
        j1 = int(ss.super[s])
        rows_s = ss.rows_of(s)
        beyond = rows_s[ns_:]
        R11t = pn[:ns_, :ns_]       # R11^T (ns x ns), lower triangular
        R12t = pn[Np:Np + (ms - ns_), :ns_]   # R12^T ((ms-ns) x ns)
        rhs = xk[j1:j1 + ns_]
        if len(beyond):
            rhs = rhs - R12t.T @ xk[beyond]
        d = np.diag(R11t)
        dead = np.abs(d) <= num.tol
        # solve R11 y = rhs  (R11 = R11t.T upper triangular)
        import scipy.linalg as sla
        R11 = R11t.T.copy()
        if dead.any():
            R11[dead, :] = 0.0
            R11[:, dead] = 0.0
            R11[dead, dead] = 1.0
            rhs = rhs.copy()
            rhs[dead] = 0.0
        y = sla.solve_triangular(R11, rhs, lower=False)
        xk[j1:j1 + ns_] = y
    return x.reshape(-1) if one_d else xk


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


def _r_matrix(num: QRNumeric):
    """R (n x n, upper triangular, permuted column order) as a host scipy
    CSR matrix, read out of the panel buffer."""
    import scipy.sparse as sp
    S = num.symbolic
    ss = S.ss
    h = num.Rbuf.cpu().numpy()
    rows, cols, vals = [], [], []
    for s in range(ss.nsuper):
        ms, ns = ss.panel_shape(s)
        Np, Mp = int(ss.panel_Np[s]), int(ss.panel_Mp[s])
        o = int(ss.panel_off[s])
        pn = h[o:o + Mp * Np].reshape(Mp, Np)
        # blk[r, t] = R[j1 + t, rows_s[r]]
        blk = np.concatenate([pn[:ns, :ns], pn[Np:Np + ms - ns, :ns]])
        r, t = np.nonzero(blk)
        rows.append(int(ss.super[s]) + t)
        cols.append(ss.rows_of(s)[r])
        vals.append(blk[r, t])
    return sp.csr_matrix((np.concatenate(vals + [h[:0]]),
                          (np.concatenate(rows + [np.zeros(0, INDEX)]),
                           np.concatenate(cols + [np.zeros(0, INDEX)]))),
                         shape=(S.n, S.n))


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
