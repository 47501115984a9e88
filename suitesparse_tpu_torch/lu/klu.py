"""KLU-class circuit-simulation LU: BTF preordering, per-block
Gilbert-Peierls left-looking sparse LU, and the refactorization hot path.

API parity with the reference (KLU/Include/klu.h:145-166):
``klu_analyze`` (BTF + per-block AMD/COLAMD, klu_analyze.c:351,143-182),
``klu_factor`` (left-looking GP with partial pivoting + diagonal preference
tol, klu_kernel.c), ``klu_refactor`` (same pattern AND pivots, values only
— the circuit-sim hot path, klu_refactor.c:7-18), ``klu_solve``/``tsolve``
(block back-substitution over BTF blocks with off-diagonal CSC gaxpy,
klu_solve.c:207-219), plus rcond/condest/rgrowth/flops diagnostics
(klu_diagnostics.c).

Counterpart of suitesparse_tpu/lu/klu.py, copied: host code over the
native Gilbert-Peierls kernel (native/src/klu.cc) with its Python twin.
Circuit matrices are far too sparse for supernodes (the reference uses no
BLAS here either); what a device can use is the *fixed-structure*
property -- analyze+factor once on the host, then ``klu_refactor`` is a
fixed program over new values.  klu_device.py is that program in PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC, invert_permutation
from ..core.status import SparseError, Status
from ..graph import btf_order
from ..ordering import amd, colamd


@dataclasses.dataclass
class KLUSymbolic:
    n: int
    p: np.ndarray          # row permutation (BTF x per-block fill ordering)
    q: np.ndarray          # column permutation
    r: np.ndarray          # block boundaries (nblocks+1)
    nblocks: int
    nmatch: int            # structural rank from maxtrans
    ordering: str


@dataclasses.dataclass
class _BlockLU:
    n: int
    Lp: np.ndarray
    Li: np.ndarray         # row indices in *final pivot order* (local)
    Lx: np.ndarray
    Up: np.ndarray
    Ui: np.ndarray
    Ux: np.ndarray
    # refactor support: per column, the A-gather and the topological column
    # order are implied by the stored U/L patterns
    pivot_rows: np.ndarray  # original local row chosen as pivot of column k


@dataclasses.dataclass
class KLUNumeric:
    sym: KLUSymbolic
    blocks: list
    pnum: np.ndarray       # final row permutation incl. partial pivoting
    Rs: np.ndarray         # row scaling applied to A (A_scaled = diag(1/Rs) A)
    offdiag: object        # scipy CSC of the permuted off-diagonal part
    singular_col: int      # n if ok
    flops: float
    p_final: object = None  # final row permutation in original coordinates

    @property
    def ok(self) -> bool:
        return self.singular_col == self.sym.n


def klu_analyze(A: SparseCSC, common: Optional[Common] = None) -> KLUSymbolic:
    """BTF + per-block fill ordering (klu_analyze.c)."""
    cm = common or default_common()
    cm.checkpoint("klu_analyze")
    n = A.ncol
    if A.nrow != n:
        raise SparseError(Status.INVALID, "klu needs a square matrix")
    if cm.lu.btf:
        res = btf_order(A)
        p, q, r, nmatch = res.p, res.q, res.r, res.nmatch
    else:
        p = np.arange(n, dtype=INDEX)
        q = np.arange(n, dtype=INDEX)
        r = np.array([0, n], dtype=INDEX)
        nmatch = n
    # per-block fill-reducing ordering (AMD on B+B' by default, klu.h)
    B = A.permute(p, q)
    ordering = cm.lu.ordering if cm.lu.ordering != "auto" else "amd"
    p2 = np.arange(n, dtype=INDEX)
    q2 = np.arange(n, dtype=INDEX)
    import scipy.sparse as sp
    S = B.to_scipy().tocsc()
    for b in range(len(r) - 1):
        lo, hi = int(r[b]), int(r[b + 1])
        if hi - lo <= 1:
            continue
        Sub = SparseCSC.from_scipy(S[lo:hi, lo:hi].tocsc())
        if ordering == "amd":
            pb = amd(Sub, cm)
        elif ordering == "colamd":
            pb = colamd(Sub, cm)
        elif ordering == "natural":
            continue
        else:
            raise SparseError(Status.INVALID, f"klu ordering {ordering}")
        p2[lo:hi] = lo + pb
        q2[lo:hi] = lo + pb       # symmetric ordering within the block
    pp = p[p2]
    qq = q[q2]
    return KLUSymbolic(n=n, p=pp.astype(INDEX), q=qq.astype(INDEX), r=r,
                       nblocks=len(r) - 1, nmatch=nmatch, ordering=ordering)


def _gp_lu_block_native(Bp, Bi, Bx, nb, tol, halt_if_singular):
    """Native C++ first-factor kernel (native/src/klu.cc) — the klu_kernel.c
    speed class.  Returns None when the native library is unavailable (the
    Python twin below is the fallback)."""
    import ctypes
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "sstpu_klu_factor"):
        return None
    dtype = np.result_type(Bx.dtype if hasattr(Bx, "dtype") else np.float64,
                           np.float64)
    is_c = np.issubdtype(dtype, np.complexfloating)
    dtype = np.complex128 if is_c else np.float64
    Bp64 = np.ascontiguousarray(Bp, dtype=np.int64)
    Bi64 = np.ascontiguousarray(Bi, dtype=np.int64)
    Bxc = np.ascontiguousarray(Bx, dtype=dtype)
    lnz = ctypes.c_int64()
    unz = ctypes.c_int64()
    sing = ctypes.c_int64()
    halted = ctypes.c_int64()
    flops = ctypes.c_double()
    umin = ctypes.c_double()
    umax = ctypes.c_double()
    h = lib.sstpu_klu_factor(
        nb, Bp64, Bi64, Bxc.ctypes.data_as(ctypes.c_void_p), float(tol),
        int(bool(halt_if_singular)), int(is_c),
        ctypes.byref(lnz), ctypes.byref(unz), ctypes.byref(sing),
        ctypes.byref(halted), ctypes.byref(flops), ctypes.byref(umin),
        ctypes.byref(umax))
    try:
        if halted.value:
            return (None, None, int(sing.value), flops.value, 0.0, 0.0)
        Lp = np.empty(nb + 1, dtype=np.int64)
        Li = np.empty(lnz.value, dtype=np.int64)
        Lx = np.empty(lnz.value, dtype=dtype)
        Up = np.empty(nb + 1, dtype=np.int64)
        Ui = np.empty(unz.value, dtype=np.int64)
        Ux = np.empty(unz.value, dtype=dtype)
        prow = np.empty(nb, dtype=np.int64)
        lib.sstpu_klu_extract(h, Lp, Li, Lx.ctypes.data_as(ctypes.c_void_p),
                              Up, Ui, Ux.ctypes.data_as(ctypes.c_void_p),
                              prow)
    finally:
        lib.sstpu_klu_free(h)
    pinv = np.full(nb, -1, dtype=INDEX)
    pinv[prow] = np.arange(nb, dtype=INDEX)
    blk = _BlockLU(n=nb, Lp=Lp.astype(INDEX), Li=Li.astype(INDEX), Lx=Lx,
                   Up=Up.astype(INDEX), Ui=Ui.astype(INDEX), Ux=Ux,
                   pivot_rows=prow.astype(INDEX))
    return (blk, pinv, int(sing.value), flops.value, umin.value, umax.value)


def _gp_lu_block(Bp, Bi, Bx, nb, tol, halt_if_singular):
    """Gilbert-Peierls block LU: native C++ kernel when available
    (native/src/klu.cc), Python twin otherwise."""
    native = _gp_lu_block_native(Bp, Bi, Bx, nb, tol, halt_if_singular)
    if native is not None:
        return native
    return _gp_lu_block_py(Bp, Bi, Bx, nb, tol, halt_if_singular)


def _gp_lu_block_py(Bp, Bi, Bx, nb, tol, halt_if_singular):
    """Gilbert-Peierls left-looking LU with partial pivoting + diagonal
    preference on one diagonal block (klu_kernel.c behavior).

    Returns (_BlockLU, pinv_local, singular_at, flops, umin, umax).
    L's stored row indices are in final pivot coordinates; columns of L are
    stored with the pivot first (unit diagonal implied, value = 1).
    """
    Lp = [0]; Li = []; Lx = []
    Up = [0]; Ui = []; Ux = []
    pinv = np.full(nb, -1, dtype=INDEX)    # orig row -> pivot position
    prow = np.full(nb, -1, dtype=INDEX)    # pivot position -> orig row
    dtype = np.result_type(Bx.dtype if hasattr(Bx, "dtype") else np.float64,
                           np.float64)
    x = np.zeros(nb, dtype=dtype)
    flag = np.zeros(nb, dtype=bool)
    singular_at = nb
    flops = 0.0
    umin, umax = np.inf, 0.0
    # per-column L adjacency in original-row space for the DFS:
    # col j of L: rows (original) with nonzero below pivot
    Lcols_rows: list[np.ndarray] = []
    Lcols_vals: list[np.ndarray] = []
    # Eisenstat-Liu symmetric pruning (klu_kernel.c prune :515): once column
    # j has a symmetric pair (U(j,k)!=0 and L(pivrow(k),j)!=0), the DFS only
    # needs the rows of L(:,j) that were already pivotal at prune time —
    # Lpend[j] marks that prefix after partitioning (-1 = unpruned).
    Lpend: list[int] = []

    for k in range(nb):
        # --- symbolic: reach of B(:,k) through computed L columns ---------
        lo, hi = int(Bp[k]), int(Bp[k + 1])
        b_rows = Bi[lo:hi]
        pattern: list[int] = []        # pivoted columns j in topo order
        stack: list[tuple[int, int]] = []
        for r0 in b_rows:
            j0 = int(pinv[r0])
            if j0 == -1 or flag[j0]:
                continue
            stack.append((j0, 0))
            flag[j0] = True
            while stack:
                j, pi = stack[-1]
                rows_j = Lcols_rows[j]
                lim = Lpend[j] if Lpend[j] >= 0 else len(rows_j)
                advanced = False
                while pi < lim:
                    jj = int(pinv[rows_j[pi]])
                    pi += 1
                    if jj != -1 and not flag[jj]:
                        stack[-1] = (j, pi)
                        stack.append((jj, 0))
                        flag[jj] = True
                        advanced = True
                        break
                if not advanced:
                    stack.pop()
                    pattern.append(j)
        pattern.reverse()              # topological order
        for j in pattern:
            flag[j] = False

        # --- numeric: sparse forward solve --------------------------------
        x[b_rows] = Bx[lo:hi]
        touched = set(b_rows.tolist())
        for j in pattern:
            pr = int(prow[j])
            xj = x[pr]
            rows_j = Lcols_rows[j]
            vals_j = Lcols_vals[j]
            if len(rows_j):
                x[rows_j] -= vals_j * xj
                touched.update(rows_j.tolist())
                flops += 2 * len(rows_j)
            touched.add(pr)

        # --- pivot: max |x| among unpivoted rows, diagonal preference -----
        cand = [r for r in touched if pinv[r] == -1]
        if not cand:
            singular_at = min(singular_at, k)
            # assign an arbitrary unpivoted row with value 0 -> singular
            free = np.where(pinv == -1)[0]
            pr_new = int(free[0])
            pivval = 0.0
        else:
            absx = np.array([abs(x[r]) for r in cand])
            maxv = absx.max()
            pr_new = cand[int(np.argmax(absx))]
            # diagonal preference: row k (original) acceptable within tol
            if pinv[k] == -1 and k in touched and abs(x[k]) >= tol * maxv and abs(x[k]) > 0:
                pr_new = k
            pivval = x[pr_new]
            if pivval == 0.0:
                singular_at = min(singular_at, k)
        if singular_at == k:
            if halt_if_singular:
                # zero out and bail
                for r in touched:
                    x[r] = 0.0
                return (None, pinv, k, flops, 0.0, 0.0)
            pivval = 1.0  # keep going with unit pivot (klu-style continue)
        umin = min(umin, abs(pivval)); umax = max(umax, abs(pivval))
        pinv[pr_new] = k
        prow[k] = pr_new

        # --- emit U column (pivoted rows) and L column (unpivoted) --------
        urows, uvals, lrows, lvals = [], [], [], []
        for r in sorted(touched):
            v = x[r]
            x[r] = 0.0
            if r == pr_new:
                continue
            jpos = int(pinv[r])
            # keep the full symbolic reach, including exactly-zero values:
            # gp_refactor clears x over the STORED pattern only, so a
            # value-dropped position going nonzero under new values would
            # leave a stale workspace entry (reference KLU keeps the reach
            # value-independently; explicit zeros are common in circuits)
            if jpos != -1:
                urows.append(jpos); uvals.append(v)
            else:
                lrows.append(r); lvals.append(v / pivval)
        # U entries in ascending pivot order = a valid topological order,
        # which klu_refactor's fixed-pattern forward solve relies on
        uorder = np.argsort(urows, kind="stable") if urows else []
        urows = [urows[t] for t in uorder]
        uvals = [uvals[t] for t in uorder]
        Ui.extend(urows); Ux.extend(uvals)
        Ui.append(k); Ux.append(pivval)          # pivot stored last in U col
        Up.append(len(Ui))
        Lcols_rows.append(np.array(lrows, dtype=INDEX))
        Lcols_vals.append(np.array(lvals))
        Lpend.append(-1)
        Li.extend(lrows); Lx.extend(lvals)       # original row ids for now
        Lp.append(len(Li))
        flops += len(lrows)

        # --- Eisenstat-Liu symmetric pruning (klu_kernel.c :515) ----------
        # For each column j with U(j,k) != 0: if L(:,j) contains the pivot
        # row of k, partition its adjacency so pivotal rows come first and
        # restrict future DFS scans to that prefix.  Numeric updates keep
        # using the full (reordered-in-sync) row/value lists.
        for j in urows:
            if Lpend[j] >= 0:
                continue
            rj = Lcols_rows[j]
            if pr_new not in rj:
                continue
            piv_mask = pinv[rj] != -1
            order = np.argsort(~piv_mask, kind="stable")
            Lcols_rows[j] = rj[order]
            Lcols_vals[j] = Lcols_vals[j][order]
            Lpend[j] = int(piv_mask.sum())

    # map L row indices to final pivot coordinates
    Li = pinv[np.array(Li, dtype=INDEX)] if Li else np.empty(0, dtype=INDEX)
    blk = _BlockLU(n=nb, Lp=np.array(Lp, dtype=INDEX), Li=np.asarray(Li, dtype=INDEX),
                   Lx=np.array(Lx, dtype=dtype), Up=np.array(Up, dtype=INDEX),
                   Ui=np.array(Ui, dtype=INDEX), Ux=np.array(Ux, dtype=dtype),
                   pivot_rows=prow.copy())
    return blk, pinv, singular_at, flops, umin, umax


def _row_scale(A: SparseCSC, mode: str) -> np.ndarray:
    if mode == "none":
        return np.ones(A.nrow)
    S = A.to_scipy().tocsr()
    absd = np.abs(S.data)
    nonempty = np.diff(S.indptr) > 0
    Rs = np.ones(A.nrow)
    if len(absd):
        red = np.maximum.reduceat if mode == "max" else np.add.reduceat
        starts = S.indptr[:-1][nonempty]
        Rs[nonempty] = red(absd, starts)
    Rs[Rs == 0.0] = 1.0
    return Rs


def klu_factor(A: SparseCSC, sym: KLUSymbolic,
               common: Optional[Common] = None) -> KLUNumeric:
    """Numeric LU of the BTF blocks (klu_factor.c)."""
    cm = common or default_common()
    cm.checkpoint("klu_factor")
    cm.tic("klu_factor")
    n = sym.n
    tol = cm.lu.sym_pivot_tol        # klu default diagonal tol 0.001
    Rs = _row_scale(A, cm.lu.scale if cm.lu.scale != "auto" else "max")
    import scipy.sparse as sp
    S = A.to_scipy().tocsr()
    S = sp.diags(1.0 / Rs) @ S
    S = sp.csc_matrix(S)[sym.p, :][:, sym.q].tocsc()

    blocks = []
    pnum = np.arange(n, dtype=INDEX)
    singular_col = n
    flops = 0.0
    umin_all, umax_all = np.inf, 0.0
    for b in range(sym.nblocks):
        lo, hi = int(sym.r[b]), int(sym.r[b + 1])
        nb = hi - lo
        Sub = S[lo:hi, lo:hi].tocsc()
        blk, pinv, sing, fl, umin, umax = _gp_lu_block(
            Sub.indptr, Sub.indices, Sub.data, nb, tol,
            cm.lu.halt_if_singular)
        if blk is None:
            cm.status = Status.SINGULAR
            raise SparseError(Status.SINGULAR,
                              f"singular at global column {lo + sing} "
                              f"(halt_if_singular)")
        if sing < nb:
            singular_col = min(singular_col, lo + sing)
        blocks.append(blk)
        # fold block pivoting into the global row permutation:
        # local pivot position k came from local original row prow[k]
        pnum[lo:hi] = pnum[lo:hi][blk.pivot_rows]
        flops += fl
        umin_all = min(umin_all, umin); umax_all = max(umax_all, umax)

    # global permuted matrix rows in final pivot order for the off-diagonal
    Sp = S[pnum, :]
    # off-diagonal part (above the diagonal blocks in block coordinates):
    # keep entries whose row and column land in different BTF blocks
    blk_of = np.repeat(np.arange(sym.nblocks, dtype=np.int64),
                       np.diff(sym.r))
    coo = Sp.tocoo()
    keep = blk_of[coo.row] != blk_of[coo.col]
    offdiag = sp.csc_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n))

    p_final = sym.p[pnum]
    num = KLUNumeric(sym=sym, blocks=blocks, pnum=pnum, Rs=Rs,
                     offdiag=offdiag, singular_col=singular_col, flops=flops,
                     p_final=p_final)
    cm.status = Status.SINGULAR if singular_col < n else Status.OK
    cm.info.update({"klu_flops": flops, "klu_umin": umin_all,
                    "klu_umax": umax_all,
                    "klu_factor_time": cm.toc("klu_factor")})
    return num


def _klu_refactor_native(blk, Sub, pinv, dtype):
    """Fixed-pattern value recompute via native/src/klu.cc; returns the
    block-local singular column (or block size), None if unavailable."""
    import ctypes
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "sstpu_klu_refactor"):
        return None
    is_c = np.issubdtype(dtype, np.complexfloating)
    Bp = np.ascontiguousarray(Sub.indptr, dtype=np.int64)
    Bi = np.ascontiguousarray(Sub.indices, dtype=np.int64)
    Bx = np.ascontiguousarray(Sub.data, dtype=np.complex128 if is_c
                              else np.float64)
    if blk.Lx.dtype != Bx.dtype:
        blk.Lx = blk.Lx.astype(Bx.dtype)
        blk.Ux = blk.Ux.astype(Bx.dtype)
    Lp = np.ascontiguousarray(blk.Lp, dtype=np.int64)
    Li = np.ascontiguousarray(blk.Li, dtype=np.int64)
    Up = np.ascontiguousarray(blk.Up, dtype=np.int64)
    Ui = np.ascontiguousarray(blk.Ui, dtype=np.int64)
    Lx = np.ascontiguousarray(blk.Lx)
    Ux = np.ascontiguousarray(blk.Ux)
    sing = lib.sstpu_klu_refactor(
        blk.n, Bp, Bi, Bx.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(pinv, dtype=np.int64), Lp, Li,
        Lx.ctypes.data_as(ctypes.c_void_p), Up, Ui,
        Ux.ctypes.data_as(ctypes.c_void_p), int(is_c))
    blk.Lx = Lx
    blk.Ux = Ux
    return int(sing)


def klu_refactor(A: SparseCSC, sym: KLUSymbolic, num: KLUNumeric,
                 common: Optional[Common] = None) -> KLUNumeric:
    """Refactorize with the SAME pattern and pivot order, new values
    (klu_refactor.c — the circuit-simulation hot path)."""
    cm = common or default_common()
    cm.checkpoint("klu_refactor")
    cm.tic("klu_refactor")
    n = sym.n
    Rs = _row_scale(A, cm.lu.scale if cm.lu.scale != "auto" else "max")
    import scipy.sparse as sp
    S = A.to_scipy().tocsr()
    S = sp.diags(1.0 / Rs) @ S
    S = sp.csc_matrix(S)[sym.p, :][:, sym.q].tocsc()

    singular_col = n
    for b in range(sym.nblocks):
        lo, hi = int(sym.r[b]), int(sym.r[b + 1])
        nb = hi - lo
        blk = num.blocks[b]
        Sub = S[lo:hi, lo:hi].tocsc()
        pinv = np.full(nb, -1, dtype=INDEX)
        pinv[blk.pivot_rows] = np.arange(nb, dtype=INDEX)
        dtype = np.result_type(Sub.dtype, np.float64)
        if blk.Lx.dtype != dtype:
            blk.Lx = blk.Lx.astype(dtype)
            blk.Ux = blk.Ux.astype(dtype)
        sing = _klu_refactor_native(blk, Sub, pinv, dtype)
        if sing is not None:
            if sing < nb:
                singular_col = min(singular_col, lo + sing)
            continue
        x = np.zeros(nb, dtype=dtype)
        for k in range(nb):
            clo, chi = int(Sub.indptr[k]), int(Sub.indptr[k + 1])
            # scatter in pivot coordinates
            rows = pinv[Sub.indices[clo:chi]]
            x[rows] = Sub.data[clo:chi]
            # forward solve in stored topological order (U column pattern)
            ulo, uhi = int(blk.Up[k]), int(blk.Up[k + 1]) - 1  # last = pivot
            for t in range(ulo, uhi):
                j = int(blk.Ui[t])
                xj = x[j]
                blk.Ux[t] = xj
                llo, lhi = int(blk.Lp[j]), int(blk.Lp[j + 1])
                if lhi > llo:
                    x[blk.Li[llo:lhi]] -= blk.Lx[llo:lhi] * xj
            piv = x[k]
            blk.Ux[uhi] = piv
            if piv == 0.0:
                singular_col = min(singular_col, lo + k)
                piv = 1.0
            llo, lhi = int(blk.Lp[k]), int(blk.Lp[k + 1])
            lr = blk.Li[llo:lhi]
            blk.Lx[llo:lhi] = x[lr] / piv
            x[lr] = 0.0
            x[blk.Ui[ulo:uhi]] = 0.0
            x[k] = 0.0
    # rebuild off-diagonal values with new data (vectorized block filter)
    Sp = S[num.pnum, :]
    blk_of = np.repeat(np.arange(sym.nblocks, dtype=np.int64),
                       np.diff(sym.r))
    coo = Sp.tocoo()
    keep = blk_of[coo.row] != blk_of[coo.col]
    num.offdiag = sp.csc_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n))
    num.Rs = Rs
    num.singular_col = singular_col
    cm.status = Status.SINGULAR if singular_col < n else Status.OK
    cm.info["klu_refactor_time"] = cm.toc("klu_refactor")
    return num


def klu_solve(num: KLUNumeric, b: np.ndarray,
              transpose: bool = False) -> np.ndarray:
    """Solve Ax=b via block back-substitution (klu_solve.c:207-219)."""
    sym = num.sym
    n = sym.n
    fdtype = num.blocks[0].Lx.dtype if num.blocks else np.float64
    b = np.asarray(b, dtype=np.result_type(np.asarray(b).dtype, fdtype,
                                           np.float64))
    one_d = b.ndim == 1
    X = b.reshape(n, -1).copy()
    if transpose:
        return _klu_tsolve(num, b)
    # scale + permute rows: x solves (R^-1 A)[pfinal, q] in block form
    X = X / num.Rs[:, None]
    X = X[num.p_final, :]
    # backward over blocks
    for blk_id in range(sym.nblocks - 1, -1, -1):
        lo, hi = int(sym.r[blk_id]), int(sym.r[blk_id + 1])
        blk = num.blocks[blk_id]
        nb = hi - lo
        xb = X[lo:hi]
        # L solve (unit lower): forward within block
        for k in range(nb):
            llo, lhi = int(blk.Lp[k]), int(blk.Lp[k + 1])
            if lhi > llo:
                xb[blk.Li[llo:lhi]] -= np.outer(blk.Lx[llo:lhi], xb[k])
        # U solve (upper, pivot last in each col): backward
        for k in range(nb - 1, -1, -1):
            ulo, uhi = int(blk.Up[k]), int(blk.Up[k + 1]) - 1
            piv = blk.Ux[uhi]
            xb[k] = xb[k] / piv
            if uhi > ulo:
                xb[blk.Ui[ulo:uhi]] -= np.outer(blk.Ux[ulo:uhi], xb[k])
        X[lo:hi] = xb
        # off-diagonal gaxpy: subtract contribution into earlier blocks
        if lo > 0:
            Fsub = num.offdiag[:lo, lo:hi]
            X[:lo] -= Fsub @ xb
    out = np.empty_like(X)
    out[sym.q, :] = X
    return out.reshape(-1) if one_d else out


def _klu_tsolve(num: KLUNumeric, b: np.ndarray) -> np.ndarray:
    """A' x = b (klu_tsolve)."""
    sym = num.sym
    n = sym.n
    fdtype = num.blocks[0].Lx.dtype if num.blocks else np.float64
    one_d = b.ndim == 1
    X = np.asarray(b, dtype=np.result_type(np.asarray(b).dtype, fdtype,
                                           np.float64)).reshape(n, -1).copy()
    X = X[sym.q, :]
    # forward over blocks (transpose of backward)
    for blk_id in range(sym.nblocks):
        lo, hi = int(sym.r[blk_id]), int(sym.r[blk_id + 1])
        blk = num.blocks[blk_id]
        nb = hi - lo
        if lo > 0:
            Fsub = num.offdiag[:lo, lo:hi]
            X[lo:hi] -= Fsub.T @ X[:lo]
        xb = X[lo:hi]
        # U' solve (lower): forward
        for k in range(nb):
            ulo, uhi = int(blk.Up[k]), int(blk.Up[k + 1]) - 1
            if uhi > ulo:
                xb[k] -= blk.Ux[ulo:uhi] @ xb[blk.Ui[ulo:uhi]]
            xb[k] = xb[k] / blk.Ux[uhi]
        # L' solve (unit upper): backward
        for k in range(nb - 1, -1, -1):
            llo, lhi = int(blk.Lp[k]), int(blk.Lp[k + 1])
            if lhi > llo:
                xb[k] -= blk.Lx[llo:lhi] @ xb[blk.Li[llo:lhi]]
        X[lo:hi] = xb
    X = X / num.Rs[num.p_final][:, None]
    out = np.empty_like(X)
    out[num.p_final, :] = X
    return out.reshape(-1) if one_d else out


# -- diagnostics (klu_diagnostics.c) ----------------------------------------

def klu_rcond(num: KLUNumeric) -> float:
    """min |piv| / max |piv| (cheap 1-norm-free estimate, klu_rcond)."""
    pivs = []
    for blk in num.blocks:
        pivs.append(np.abs(blk.Ux[blk.Up[1:] - 1]))
    d = np.concatenate(pivs) if pivs else np.array([1.0])
    mx = d.max()
    return float(d.min() / mx) if mx > 0 else 0.0


def klu_rgrowth(A: SparseCSC, num: KLUNumeric) -> float:
    """Reciprocal pivot growth: min_k (max|A(:,k)| / max|U(:,k)|)."""
    sym = num.sym
    import scipy.sparse as sp
    S = sp.csc_matrix(sp.diags(1.0 / num.Rs) @ A.to_scipy().tocsr())[sym.p, :][:, sym.q].tocsc()
    growth = np.inf
    for b in range(sym.nblocks):
        lo, hi = int(sym.r[b]), int(sym.r[b + 1])
        blk = num.blocks[b]
        Sub = S[lo:hi, lo:hi].tocsc()
        for k in range(hi - lo):
            amax = np.abs(Sub.data[Sub.indptr[k]:Sub.indptr[k + 1]]).max(initial=0.0)
            ulo, uhi = int(blk.Up[k]), int(blk.Up[k + 1])
            umax = np.abs(blk.Ux[ulo:uhi]).max(initial=0.0)
            if umax > 0 and amax > 0:
                growth = min(growth, amax / umax)
    return float(growth if np.isfinite(growth) else 1.0)


def klu_condest(A: SparseCSC, num: KLUNumeric) -> float:
    """Hager/Higham style 1-norm condition estimate (klu_condest)."""
    n = num.sym.n
    anorm = A.norm(1)
    # ||A^-1||_1 estimate by a few power iterations on the dual norm
    x = np.full(n, 1.0 / n)
    est = 0.0
    for _ in range(5):
        y = klu_solve(num, x)
        est = np.abs(y).sum()
        s = np.sign(y)
        z = klu_solve(num, s, transpose=True)
        j = int(np.argmax(np.abs(z)))
        if np.abs(z[j]) <= z @ x:
            break
        x = np.zeros(n)
        x[j] = 1.0
    return float(anorm * est)
