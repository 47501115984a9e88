"""Host-side sparse containers: CSC, triplet, dense.

TPU-native analog of the reference object model — cholmod_sparse (CSC,
cholmod_core.h:1243), cholmod_triplet (:2195), cholmod_dense (:1976), and
CSparse's ``cs`` struct (CSparse/Include/cs.h).  Analysis (orderings,
etrees, symbolic factorization) is host-side O(nnz) work that runs once per
pattern, so these containers are NumPy-backed; numeric device work uses
packed dense panels produced by the symbolic phase (see cholesky/, lu/).

Design differences from the reference (deliberate, TPU-first):
  * no malloc discipline — NumPy owns memory;
  * indices are always int64 (``SuiteSparse_long`` everywhere; no dual
    int/long compilation — SURVEY.md §2 item 30);
  * dtype polymorphism (float32/float64/complex64/complex128) replaces the
    xtype/dtype enums and the di/dl/zi/zl compiled variants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from .status import SparseError, Status

# stype convention follows cholmod_core.h:1243:
#   0  : unsymmetric — both triangles stored
#   >0 : symmetric, upper triangle stored
#   <0 : symmetric, lower triangle stored
UNSYM, SYM_UPPER, SYM_LOWER = 0, 1, -1

INDEX = np.int64


def _as_index(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=INDEX)


@dataclasses.dataclass
class SparseCSC:
    """Compressed-sparse-column matrix (cholmod_sparse / cs analog)."""

    indptr: np.ndarray          # (ncol+1,) int64
    indices: np.ndarray         # (nnz,) int64 row indices
    data: Optional[np.ndarray]  # (nnz,) values, or None for pattern-only
    shape: tuple[int, int]
    stype: int = UNSYM
    sorted: bool = True         # columns sorted by row index

    # -- construction ------------------------------------------------------
    def __post_init__(self):
        self.indptr = _as_index(self.indptr)
        self.indices = _as_index(self.indices)
        if self.data is not None:
            self.data = np.ascontiguousarray(self.data)

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def dtype(self):
        return self.data.dtype if self.data is not None else None

    @property
    def is_pattern(self) -> bool:
        return self.data is None

    @classmethod
    def from_scipy(cls, A, stype: int = UNSYM) -> "SparseCSC":
        import scipy.sparse as sp

        A = sp.csc_matrix(A)
        A.sort_indices()
        return cls(A.indptr, A.indices, A.data.copy(), A.shape, stype=stype)

    def to_scipy(self):
        import scipy.sparse as sp

        A = sp.csc_matrix(
            (self.data if self.data is not None else np.ones(self.nnz),
             self.indices, self.indptr),
            shape=self.shape,
        )
        if self.stype != UNSYM:
            # expand symmetric storage to full (hermitian for complex data,
            # the cholmod convention for complex stype != 0)
            D = sp.diags(A.diagonal())
            At = A.conj().T if np.iscomplexobj(A.data) else A.T
            A = A + At - D
        return A

    @classmethod
    def from_triplet(cls, t: "Triplet") -> "SparseCSC":
        """Triplet→CSC with duplicate summation (cholmod_triplet_to_sparse /
        cs_compress + cs_dupl)."""
        nrow, ncol = t.shape
        order = np.lexsort((t.row, t.col))
        col = t.col[order]
        row = t.row[order]
        val = t.data[order] if t.data is not None else None
        # collapse duplicates
        if len(row):
            new = np.empty(len(row), dtype=bool)
            new[0] = True
            new[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
            idx = np.cumsum(new) - 1
            urow, ucol = row[new], col[new]
            if val is not None:
                uval = np.zeros(int(idx[-1]) + 1, dtype=val.dtype)
                np.add.at(uval, idx, val)
            else:
                uval = None
        else:
            urow, ucol, uval = row, col, val
        indptr = np.zeros(ncol + 1, dtype=INDEX)
        np.add.at(indptr, ucol + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr, urow, uval, (nrow, ncol), stype=t.stype)

    def to_triplet(self) -> "Triplet":
        col = np.repeat(np.arange(self.ncol, dtype=INDEX), np.diff(self.indptr))
        return Triplet(self.indices.copy(), col,
                       None if self.data is None else self.data.copy(),
                       self.shape, stype=self.stype)

    # -- basic structural ops (cholmod Core / CSparse utilities) -----------
    def copy(self) -> "SparseCSC":
        return SparseCSC(self.indptr.copy(), self.indices.copy(),
                         None if self.data is None else self.data.copy(),
                         self.shape, self.stype, self.sorted)

    def sort_indices(self) -> "SparseCSC":
        """In-place column sort (cholmod_sort / cs style double-transpose not
        needed: argsort per column via lexsort is O(nnz log nnz) host work)."""
        if self.sorted:
            return self
        col = np.repeat(np.arange(self.ncol, dtype=INDEX), np.diff(self.indptr))
        order = np.lexsort((self.indices, col))
        self.indices = self.indices[order]
        if self.data is not None:
            self.data = self.data[order]
        self.sorted = True
        return self

    def transpose(self, values: bool = True,
                  conjugate: bool = False) -> "SparseCSC":
        """A' in CSC (cholmod_transpose / cs_transpose).  For stype != 0 this
        flips the stored triangle; conjugate=True gives the adjoint."""
        nrow, ncol = self.shape
        indptr = np.zeros(nrow + 1, dtype=INDEX)
        np.add.at(indptr, self.indices + 1, 1)
        np.cumsum(indptr, out=indptr)
        # stable counting-sort by row => transposed columns come out sorted
        next_ = indptr[:-1].copy()
        tind = np.empty(self.nnz, dtype=INDEX)
        tdat = (np.empty(self.nnz, dtype=self.data.dtype)
                if (values and self.data is not None) else None)
        col = np.repeat(np.arange(ncol, dtype=INDEX), np.diff(self.indptr))
        # vectorized counting sort: position of entry k in the transpose
        order = np.argsort(self.indices, kind="stable")
        tind = col[order]
        if tdat is not None:
            tdat = self.data[order]
            if conjugate and np.iscomplexobj(tdat):
                tdat = np.conj(tdat)
        del next_
        return SparseCSC(indptr, tind, tdat, (ncol, nrow),
                         stype=-self.stype, sorted=True)

    def to_full_storage(self) -> "SparseCSC":
        """Expand symmetric (half-stored) to full unsymmetric storage."""
        if self.stype == UNSYM:
            return self
        t = self.transpose()
        t.stype = UNSYM
        me = self.copy()
        me.stype = UNSYM
        S = add(me, t)
        # diagonal was counted twice — subtract it once (vectorized: the
        # per-column searchsorted loop was ~1 s at n=262k)
        if S.data is not None:
            d = extract_diagonal(self)
            col = np.repeat(np.arange(S.ncol, dtype=INDEX),
                            np.diff(S.indptr))
            pos = np.nonzero(S.indices == col)[0]
            j_of = col[pos]
            ok = j_of < len(d)
            S.data[pos[ok]] -= d[j_of[ok]]
        else:
            # pattern: duplicates already merged by add()
            pass
        return S

    def band(self, k1: int, k2: int) -> "SparseCSC":
        """Keep entries with k1 <= (col-row) <= k2 (cholmod_band / cs_band)."""
        col = np.repeat(np.arange(self.ncol, dtype=INDEX), np.diff(self.indptr))
        d = col - self.indices
        keep = (d >= k1) & (d <= k2)
        return _filtered(self, keep)

    def tril(self, k: int = 0) -> "SparseCSC":
        return self.band(-self.nrow, k)

    def triu(self, k: int = 0) -> "SparseCSC":
        return self.band(k, self.ncol)

    def drop(self, tol: float) -> "SparseCSC":
        """cholmod_drop / cs_droptol: drop |a_ij| <= tol off-diagonal."""
        if self.data is None:
            return self.copy()
        col = np.repeat(np.arange(self.ncol, dtype=INDEX), np.diff(self.indptr))
        keep = (np.abs(self.data) > tol) | (self.indices == col)
        return _filtered(self, keep)

    def permute(self, p: Optional[np.ndarray], q: Optional[np.ndarray],
                values: bool = True) -> "SparseCSC":
        """C = A(p, q) (cs_permute).  p permutes rows, q permutes columns;
        ``p[k] = i`` means row i of A becomes row k of C."""
        nrow, ncol = self.shape
        pinv = invert_permutation(p) if p is not None else None
        qq = np.arange(ncol, dtype=INDEX) if q is None else _as_index(q)
        counts = np.diff(self.indptr)[qq]
        indptr = np.zeros(ncol + 1, dtype=INDEX)
        np.cumsum(counts, out=indptr[1:])
        nnz = int(indptr[-1])
        indices = np.empty(nnz, dtype=INDEX)
        data = (np.empty(nnz, dtype=self.data.dtype)
                if (values and self.data is not None) else None)
        # gather per permuted column
        src = np.concatenate(
            [np.arange(self.indptr[j], self.indptr[j + 1]) for j in qq]
        ) if ncol else np.empty(0, dtype=INDEX)
        rows = self.indices[src]
        indices[:] = pinv[rows] if pinv is not None else rows
        if data is not None:
            data[:] = self.data[src]
        C = SparseCSC(indptr, indices, data, self.shape, stype=UNSYM,
                      sorted=(pinv is None))
        return C.sort_indices()

    def symperm(self, p: np.ndarray, values: bool = True) -> "SparseCSC":
        """C = PAP' keeping upper-triangular storage (cs_symperm /
        cholmod_ptranspose for stype>0).  Requires stype != 0 upper."""
        if self.stype == 0:
            raise SparseError(Status.INVALID, "symperm requires symmetric storage")
        A = self if self.stype > 0 else self.transpose()
        n = A.ncol
        pinv = invert_permutation(p)
        col = np.repeat(np.arange(n, dtype=INDEX), np.diff(A.indptr))
        i2, j2 = pinv[A.indices], pinv[col]
        r = np.minimum(i2, j2)
        c = np.maximum(i2, j2)
        order = np.lexsort((r, c))
        indptr = np.zeros(n + 1, dtype=INDEX)
        np.add.at(indptr, c + 1, 1)
        np.cumsum(indptr, out=indptr)
        data = None
        if values and A.data is not None:
            data = A.data.copy()
            if np.iscomplexobj(data):
                # hermitian storage: entries that flip triangle conjugate
                data = np.where(i2 > j2, np.conj(data), data)
            data = data[order]
        return SparseCSC(indptr, r[order], data, (n, n), stype=SYM_UPPER,
                         sorted=True)

    def diagonal(self) -> np.ndarray:
        return extract_diagonal(self)

    def norm(self, kind: Union[int, float, str] = 1) -> float:
        """cholmod_norm_sparse: 1-norm (max col sum) or inf-norm (max row sum)."""
        if self.data is None:
            raise SparseError(Status.INVALID, "norm of pattern-only matrix")
        A = self.to_full_storage() if self.stype != UNSYM else self
        absd = np.abs(A.data)
        if kind in (1, "1"):
            sums = np.add.reduceat(absd, A.indptr[:-1]) if A.nnz else np.zeros(A.ncol)
            sums = np.where(np.diff(A.indptr) == 0, 0.0, sums)
            return float(sums.max(initial=0.0))
        if kind in (np.inf, "inf"):
            rs = np.zeros(A.nrow)
            np.add.at(rs, A.indices, absd)
            return float(rs.max(initial=0.0))
        raise SparseError(Status.INVALID, f"unsupported norm {kind!r}")

    def check(self) -> bool:
        """Structural validation (cholmod_check_sparse / amd_valid analog)."""
        nrow, ncol = self.shape
        ip = self.indptr
        if len(ip) != ncol + 1 or ip[0] != 0 or np.any(np.diff(ip) < 0):
            return False
        if self.nnz != len(self.indices):
            return False
        if self.nnz and (self.indices.min() < 0 or self.indices.max() >= nrow):
            return False
        if self.sorted:
            for j in range(ncol):
                c = self.indices[ip[j]:ip[j + 1]]
                if np.any(np.diff(c) <= 0):
                    return False
        if self.data is not None and len(self.data) != self.nnz:
            return False
        return True

    def __matmul__(self, other):
        # the reference routes through its ops package (cholmod_sdmult /
        # cholmod_ssmult); the port carries no ops package yet, so the same
        # two products are computed through scipy here
        if isinstance(other, SparseCSC):
            if self.ncol != other.nrow:
                raise SparseError(Status.INVALID,
                                  "ssmult: inner dimension mismatch")
            C = (self.to_scipy() @ other.to_scipy()).tocsc()
            C.sort_indices()
            return SparseCSC(C.indptr, C.indices, C.data, C.shape,
                             stype=UNSYM)
        return np.asarray(self.to_scipy() @ np.asarray(other))


@dataclasses.dataclass
class Triplet:
    """COO matrix (cholmod_triplet analog)."""

    row: np.ndarray
    col: np.ndarray
    data: Optional[np.ndarray]
    shape: tuple[int, int]
    stype: int = UNSYM

    def __post_init__(self):
        self.row = _as_index(self.row)
        self.col = _as_index(self.col)
        if self.data is not None:
            self.data = np.asarray(self.data)

    @property
    def nnz(self) -> int:
        return len(self.row)

    def to_csc(self) -> SparseCSC:
        return SparseCSC.from_triplet(self)


# ---------------------------------------------------------------------------
# Free functions (cholmod Core / MatrixOps & CSparse equivalents)
# ---------------------------------------------------------------------------

def _filtered(A: SparseCSC, keep: np.ndarray) -> SparseCSC:
    col = np.repeat(np.arange(A.ncol, dtype=INDEX), np.diff(A.indptr))
    kcol = col[keep]
    indptr = np.zeros(A.ncol + 1, dtype=INDEX)
    np.add.at(indptr, kcol + 1, 1)
    np.cumsum(indptr, out=indptr)
    return SparseCSC(indptr, A.indices[keep],
                     None if A.data is None else A.data[keep],
                     A.shape, stype=A.stype, sorted=A.sorted)


def sym_upper_view(A: "SparseCSC") -> "SparseCSC":
    """Canonical upper-triangular view of a symmetric/hermitian matrix:
    stype>0 as-is; stype<0 via (conjugating, for complex) transpose;
    stype==0 takes triu (values assumed consistent)."""
    if A.stype > 0:
        return A
    if A.stype < 0:
        return A.transpose(conjugate=np.iscomplexobj(A.data)
                           if A.data is not None else False)
    U = A.triu(0)
    U.stype = SYM_UPPER
    return U


def invert_permutation(p: np.ndarray) -> np.ndarray:
    p = _as_index(p)
    pinv = np.empty_like(p)
    pinv[p] = np.arange(len(p), dtype=INDEX)
    return pinv


def extract_diagonal(A: SparseCSC) -> np.ndarray:
    n = min(A.shape)
    d = np.zeros(n, dtype=A.dtype if A.data is not None else np.float64)
    col = np.repeat(np.arange(A.ncol, dtype=INDEX), np.diff(A.indptr))
    hit = A.indices == col
    if A.data is not None:
        np.add.at(d, col[hit], A.data[hit])
    else:
        d[col[hit]] = 1.0
    return d


def eye(n: int, dtype=np.float64) -> SparseCSC:
    """cholmod_speye."""
    return SparseCSC(np.arange(n + 1, dtype=INDEX), np.arange(n, dtype=INDEX),
                     np.ones(n, dtype=dtype), (n, n))


def spzeros(nrow: int, ncol: int, dtype=np.float64) -> SparseCSC:
    return SparseCSC(np.zeros(ncol + 1, dtype=INDEX), np.empty(0, dtype=INDEX),
                     np.empty(0, dtype=dtype), (nrow, ncol))


def add(A: SparseCSC, B: SparseCSC, alpha: float = 1.0, beta: float = 1.0) -> SparseCSC:
    """C = alpha A + beta B (cholmod_add / cs_add) — host scipy-grade op."""
    if A.shape != B.shape:
        raise SparseError(Status.INVALID, "add: shape mismatch")
    rowA = A.indices
    colA = np.repeat(np.arange(A.ncol, dtype=INDEX), np.diff(A.indptr))
    rowB = B.indices
    colB = np.repeat(np.arange(B.ncol, dtype=INDEX), np.diff(B.indptr))
    row = np.concatenate([rowA, rowB])
    col = np.concatenate([colA, colB])
    if A.data is not None and B.data is not None:
        dt = np.result_type(A.data.dtype, B.data.dtype)
        dat = np.concatenate([alpha * A.data.astype(dt), beta * B.data.astype(dt)])
    else:
        dat = None
    return Triplet(row, col, dat, A.shape, stype=A.stype if A.stype == B.stype else UNSYM).to_csc()


def aat(A: SparseCSC, mode: str = "pattern") -> SparseCSC:
    """A*A' (cholmod_aat). mode: 'pattern' | 'numeric'."""
    import scipy.sparse as sp

    S = A.to_scipy()
    C = (S @ S.T).tocsc()
    C.sort_indices()
    if mode == "pattern":
        return SparseCSC(C.indptr.astype(INDEX), C.indices.astype(INDEX), None, C.shape)
    return SparseCSC(C.indptr.astype(INDEX), C.indices.astype(INDEX), C.data, C.shape)


def horzcat(A: SparseCSC, B: SparseCSC) -> SparseCSC:
    if A.nrow != B.nrow:
        raise SparseError(Status.INVALID, "horzcat: row mismatch")
    indptr = np.concatenate([A.indptr, A.indptr[-1] + B.indptr[1:]])
    indices = np.concatenate([A.indices, B.indices])
    data = None
    if A.data is not None and B.data is not None:
        data = np.concatenate([A.data, B.data])
    return SparseCSC(indptr, indices, data, (A.nrow, A.ncol + B.ncol))


def vertcat(A: SparseCSC, B: SparseCSC) -> SparseCSC:
    if A.ncol != B.ncol:
        raise SparseError(Status.INVALID, "vertcat: col mismatch")
    t = horzcat(A.transpose(), B.transpose())
    return t.transpose()


def submatrix(A: SparseCSC, rows: Optional[np.ndarray], cols: Optional[np.ndarray]) -> SparseCSC:
    """C = A(rows, cols) (cholmod_submatrix)."""
    rset = np.arange(A.nrow, dtype=INDEX) if rows is None else _as_index(rows)
    cset = np.arange(A.ncol, dtype=INDEX) if cols is None else _as_index(cols)
    rmap = -np.ones(A.nrow, dtype=INDEX)
    rmap[rset] = np.arange(len(rset), dtype=INDEX)
    # vectorized column-slice gather (no per-column Python loop)
    starts = A.indptr[cset].astype(np.int64)
    lens = (A.indptr[cset + 1] - A.indptr[cset]).astype(np.int64)
    total = int(lens.sum())
    cum = np.zeros(len(cset), dtype=np.int64)
    np.cumsum(lens[:-1], out=cum[1:])
    idx = np.arange(total, dtype=np.int64) + np.repeat(starts - cum, lens)
    m = rmap[A.indices[idx]]
    keep = m >= 0
    colid = np.repeat(np.arange(len(cset), dtype=np.int64), lens)
    counts = np.bincount(colid[keep], minlength=len(cset))
    indptr = np.zeros(len(cset) + 1, dtype=INDEX)
    np.cumsum(counts, out=indptr[1:])
    indices = m[keep].astype(INDEX)
    data = A.data[idx][keep] if A.data is not None else None
    C = SparseCSC(indptr, indices, data, (len(rset), len(cset)))
    return C.sort_indices() if not C.sorted else C


def symmetry(A: SparseCSC) -> tuple[float, int]:
    """Pattern symmetry in [0,1] and count of nonzero diagonal entries
    (cholmod_symmetry; used by UMFPACK auto strategy umfpack_qsymbolic.c:1232)."""
    if A.nrow != A.ncol:
        return 0.0, 0
    col = np.repeat(np.arange(A.ncol, dtype=INDEX), np.diff(A.indptr))
    offdiag = A.indices != col
    nzdiag = int((~offdiag).sum())
    if not offdiag.any():
        return 1.0, nzdiag
    ij = set(zip(A.indices[offdiag].tolist(), col[offdiag].tolist()))
    matched = sum(1 for (i, j) in ij if (j, i) in ij)
    return matched / len(ij), nzdiag
