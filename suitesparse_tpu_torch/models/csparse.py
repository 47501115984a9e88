"""cs_* compatibility namespace (CSparse/CXSparse API parity layer).

Counterpart of suitesparse_tpu/models/csparse.py; each function calls the
port's counterpart of the reference's.  The Cholesky and QR solves and
cs_qr factor on ``device`` (the card when None; raises without one);
everything else runs on the host.

Every entry point from CSparse/Include/cs.h:26-142 (SURVEY.md Appendix A)
mapped onto the framework's native modules.  CXSparse's four type variants
collapse into dtype polymorphism (complex data just works); the `cs_di_/
cs_dl_/cs_ci_/cs_cl_` prefixes are therefore one namespace here.
Citations are per-function to the reference files they mirror.
"""
from __future__ import annotations

import numpy as np

from ..core.sparse import (SparseCSC, Triplet, add as _add, eye,
                           invert_permutation)
from ..core.status import SparseError, Status
from ..graph import dmperm as _dmperm, etree as _etree, postorder as _post
from ..graph import col_counts as _counts, maxtrans as _maxtrans
from ..graph.btf import strongcomp as _scc
from ..ordering import amd as _amd
from ..ops.host import sdmult, ssmult

# -- primary (cs.h "primary routines") --------------------------------------

def cs_add(A, B, alpha=1.0, beta=1.0):
    """cs_add.c"""
    return _add(A, B, alpha, beta)


def cs_multiply(A, B):
    """cs_multiply.c"""
    return ssmult(A, B)


def cs_gaxpy(A, x, y):
    """cs_gaxpy.c: y += A x"""
    return y + sdmult(A, x)


def cs_transpose(A):
    """cs_transpose.c"""
    return A.transpose()


def cs_compress(T: Triplet):
    """cs_compress.c"""
    return T.to_csc()


def cs_entry(T: Triplet, i, j, x):
    """cs_entry.c: append one triplet entry"""
    T.row = np.append(T.row, i)
    T.col = np.append(T.col, j)
    T.data = np.append(T.data if T.data is not None else [], x)
    return T


def cs_norm(A):
    """cs_norm.c: 1-norm"""
    return A.norm(1)


def cs_print(A, brief=True):
    """cs_print.c"""
    print(f"{A.nrow}-by-{A.ncol}, nnz {A.nnz}")
    if not brief:
        t = A.to_triplet()
        for k in range(t.nnz):
            print(f"  ({t.row[k]},{t.col[k]}) : "
                  f"{t.data[k] if t.data is not None else 1}")


def cs_load(f):
    """cs_load.c: read whitespace triplet file (i j x per line, 0-based)."""
    data = np.loadtxt(f, ndmin=2)
    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    vals = data[:, 2] if data.shape[1] > 2 else None
    shape = (int(rows.max()) + 1, int(cols.max()) + 1)
    return Triplet(rows, cols, vals, shape).to_csc()


def cs_lusol(A, b, order=1, tol=1e-3):
    """cs_lusol.c: x = A\\b via LU."""
    from ..lu import klu_analyze, klu_factor, klu_solve
    from ..core.common import default_common
    cm = default_common()
    cm.lu.btf = False
    cm.lu.ordering = "amd" if order in (1, 2) else ("colamd" if order == 3
                                                    else "natural")
    num = klu_factor(A, klu_analyze(A, cm), cm)
    return klu_solve(num, np.asarray(b, dtype=np.float64))


def cs_cholsol(A, b, order=1, device=None):
    """cs_cholsol.c: x = A\\b via Cholesky."""
    from ..cholesky import spsolve_chol
    return spsolve_chol(A, np.asarray(b, dtype=np.float64), device=device)


def cs_qrsol(A, b, order=3, device=None):
    """cs_qrsol.c: least-squares via QR."""
    from ..qr import qr_solve
    return qr_solve(A, np.asarray(b, dtype=np.float64), device=device)


def cs_dmperm(A):
    """cs_dmperm.c"""
    return _dmperm(A)


def cs_scc(A):
    """cs_scc.c"""
    return _scc(A.indptr, A.indices, A.ncol)


# -- secondary --------------------------------------------------------------

def cs_amd(A, order=1):
    """cs_amd.c"""
    if order == 0:
        return np.arange(A.ncol, dtype=np.int64)
    from ..io.generators import symmetrize_upper
    return _amd(A if A.stype else symmetrize_upper(A))


def cs_etree(A, ata=False):
    """cs_etree.c"""
    return _etree(A, col=ata)


def cs_post(parent):
    """cs_post.c"""
    return _post(parent)


def cs_counts(A, parent, post, ata=False):
    """cs_counts.c"""
    if ata:
        raise SparseError(Status.NOT_AVAILABLE, "ata counts: next round")
    return _counts(A, parent, post)


def cs_chol(A, order=1):
    """cs_chol.c: simplicial LL' factor object."""
    from ..cholesky import factorize_simplicial
    return factorize_simplicial(A, ll=True)


def cs_lu(A, order=2, tol=1.0):
    """cs_lu.c"""
    from ..lu import klu_analyze, klu_factor
    from ..core.common import default_common
    cm = default_common()
    cm.lu.btf = False
    num = klu_factor(A, klu_analyze(A, cm), cm)
    return num


def cs_qr(A, device=None):
    """cs_qr.c: (QRSymbolic, QRNumeric)."""
    from ..qr import qr_factorize, qr_symbolic
    S = qr_symbolic(A)
    return S, qr_factorize(A, S, device=device)


def cs_lsolve(L, x):
    """cs_lsolve.c: x = L\\x, L lower CSC with sorted cols, diag first."""
    x = np.array(x, dtype=np.float64)
    for j in range(L.ncol):
        lo, hi = int(L.indptr[j]), int(L.indptr[j + 1])
        x[j] /= L.data[lo]
        x[L.indices[lo + 1:hi]] -= L.data[lo + 1:hi] * x[j]
    return x


def cs_ltsolve(L, x):
    """cs_ltsolve.c: x = L'\\x."""
    x = np.array(x, dtype=np.float64)
    for j in range(L.ncol - 1, -1, -1):
        lo, hi = int(L.indptr[j]), int(L.indptr[j + 1])
        x[j] -= np.dot(L.data[lo + 1:hi], x[L.indices[lo + 1:hi]])
        x[j] /= L.data[lo]
    return x


def cs_usolve(U, x):
    """cs_usolve.c: x = U\\x, U upper CSC (diag last per column)."""
    x = np.array(x, dtype=np.float64)
    for j in range(U.ncol - 1, -1, -1):
        lo, hi = int(U.indptr[j]), int(U.indptr[j + 1])
        x[j] /= U.data[hi - 1]
        x[U.indices[lo:hi - 1]] -= U.data[lo:hi - 1] * x[j]
    return x


def cs_utsolve(U, x):
    """cs_utsolve.c: x = U'\\x."""
    x = np.array(x, dtype=np.float64)
    for j in range(U.ncol):
        lo, hi = int(U.indptr[j]), int(U.indptr[j + 1])
        x[j] -= np.dot(U.data[lo:hi - 1], x[U.indices[lo:hi - 1]])
        x[j] /= U.data[hi - 1]
    return x


def cs_spsolve(G, B, k, lower=True):
    """cs_spsolve.c: sparse x = G\\B(:,k) — returns (pattern, x)."""
    from ..graph import reach
    patt = reach(G.indptr, G.indices, B.indptr, B.indices, k)
    n = G.ncol
    x = np.zeros(n)
    lo, hi = int(B.indptr[k]), int(B.indptr[k + 1])
    x[B.indices[lo:hi]] = B.data[lo:hi]
    for j in patt:
        j = int(j)
        lo, hi = int(G.indptr[j]), int(G.indptr[j + 1])
        if lower:
            x[j] /= G.data[lo]
            x[G.indices[lo + 1:hi]] -= G.data[lo + 1:hi] * x[j]
        else:
            x[j] /= G.data[hi - 1]
            x[G.indices[lo:hi - 1]] -= G.data[lo:hi - 1] * x[j]
    return patt, x


def cs_reach(G, B, k):
    """cs_reach.c"""
    from ..graph import reach
    return reach(G.indptr, G.indices, B.indptr, B.indices, k)


def cs_maxtrans(A):
    """cs_maxtrans.c"""
    return _maxtrans(A)


def cs_permute(A, p, q):
    """cs_permute.c"""
    return A.permute(p, q)


def cs_symperm(A, p):
    """cs_symperm.c"""
    return A.symperm(p)


def cs_pinv(p):
    """cs_pinv.c"""
    return invert_permutation(p)


def cs_pvec(p, b):
    """cs_pvec.c: x = b(p)"""
    return np.asarray(b)[p]


def cs_ipvec(p, b):
    """cs_ipvec.c: x(p) = b"""
    x = np.empty_like(np.asarray(b))
    x[p] = b
    return x


def cs_droptol(A, tol):
    """cs_droptol.c"""
    return A.drop(tol)


def cs_dropzeros(A):
    """cs_dropzeros.c"""
    return A.drop(0.0)


def cs_fkeep(A, fkeep):
    """cs_fkeep.c: keep entries where fkeep(i, j, x) is true."""
    t = A.to_triplet()
    keep = np.array([bool(fkeep(int(t.row[k]), int(t.col[k]),
                                t.data[k] if t.data is not None else 1.0))
                     for k in range(t.nnz)])
    return Triplet(t.row[keep], t.col[keep],
                   None if t.data is None else t.data[keep], t.shape).to_csc()


def cs_updown(L_factor, sigma, C):
    """cs_updown.c: rank-1 update/downdate of an LDL-style factor."""
    from ..cholesky.modify import updown
    return updown(L_factor, C, update=(sigma > 0))


def cs_house(x):
    """cs_house.c: Householder reflection (v, beta, s)."""
    x = np.asarray(x, dtype=np.float64)
    sigma = np.dot(x[1:], x[1:])
    v = x.copy()
    if sigma == 0:
        s = abs(x[0])
        beta = 2.0 if x[0] <= 0 else 0.0
        v[0] = 1.0 if x[0] <= 0 else x[0]
    else:
        s = np.sqrt(x[0] ** 2 + sigma)
        v[0] = x[0] - s if x[0] <= 0 else -sigma / (x[0] + s)
        beta = -1.0 / (s * v[0])
    return v, beta, s


def cs_happly(V, j, beta, x):
    """cs_happly.c: x = (I - beta v v') x with sparse v = V(:,j)."""
    x = np.array(x, dtype=np.float64)
    lo, hi = int(V.indptr[j]), int(V.indptr[j + 1])
    rows = V.indices[lo:hi]
    v = V.data[lo:hi]
    tau = np.dot(v, x[rows])
    x[rows] -= beta * tau * v
    return x


def cs_randperm(n, seed=0):
    """cs_randperm.c"""
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


def cs_cumsum(c):
    """cs_cumsum.c"""
    p = np.zeros(len(c) + 1, dtype=np.int64)
    np.cumsum(c, out=p[1:])
    return p


def cs_scatter(A, j, beta, w, x, mark):
    """cs_scatter.c semantics via numpy (used by textbook algorithms)."""
    lo, hi = int(A.indptr[j]), int(A.indptr[j + 1])
    rows = A.indices[lo:hi]
    fresh = w[rows] < mark
    w[rows] = mark
    x[rows[fresh]] = beta * A.data[lo:hi][fresh]
    x[rows[~fresh]] += beta * A.data[lo:hi][~fresh]
    return rows[fresh]
