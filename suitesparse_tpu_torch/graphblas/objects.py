"""GraphBLAS object model: storage formats, vectors, descriptors, iterators.

Counterpart of suitesparse_tpu/graphblas/objects.py, copied: host NumPy
containers and conversions, no device work.

Reference coverage (GraphBLAS, SURVEY.md §2 item 24):
  * the 8 storage variants — {CSR,CSC} x {hypersparse, sparse, bitmap,
    full} (+ iso compression) of Source/Template/GB_matrix.h:10-50 — map
    here to a `fmt`/`orientation` tag on GrBMatrix with explicit
    conversions.  Bitmap and full ARE the dense device formats (dense
    value array + presence mask -> dense elementwise and product paths);
    sparse keeps the COO device form; hypersparse additionally
    carries the nonempty-column list so O(#nonempty) iteration is possible
    (the reference's h-list, GB_matrix.h);
  * GrB_Vector (sparse vector object, GraphBLAS.h GrB_Vector_* family);
  * GrB_Descriptor (GrB_DESC_* flags: transpose inputs, complement mask,
    structural mask, replace);
  * GxB_Iterator (row/col/entry traversal, GraphBLAS.h GxB_Iterator_*);
  * iso detection (GxB_Matrix_iso): all stored values equal.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.sparse import INDEX, SparseCSC, Triplet
from ..core.status import SparseError, Status

HYPERSPARSE = "hypersparse"
SPARSE = "sparse"
BITMAP = "bitmap"
FULL = "full"
FORMATS = (HYPERSPARSE, SPARSE, BITMAP, FULL)

BY_ROW = "by_row"
BY_COL = "by_col"


@dataclasses.dataclass
class Descriptor:
    """GrB_Descriptor: per-call behavior flags (GrB_DESC_* catalog).

    transpose0/transpose1 = GrB_INP0/INP1 with GrB_TRAN;
    mask_complement = GrB_COMP; mask_structure = GrB_STRUCTURE;
    replace = GrB_REPLACE (clear non-masked output entries).
    """

    transpose0: bool = False
    transpose1: bool = False
    mask_complement: bool = False
    mask_structure: bool = False
    replace: bool = False


# the GrB_DESC_* shorthands (GraphBLAS.h predefined descriptors)
DESC_T0 = Descriptor(transpose0=True)
DESC_T1 = Descriptor(transpose1=True)
DESC_T0T1 = Descriptor(transpose0=True, transpose1=True)
DESC_C = Descriptor(mask_complement=True)
DESC_S = Descriptor(mask_structure=True)
DESC_R = Descriptor(replace=True)
DESC_RC = Descriptor(replace=True, mask_complement=True)
DESC_SC = Descriptor(mask_structure=True, mask_complement=True)


@dataclasses.dataclass
class GrBVector:
    """GrB_Vector: sparse n-vector (indices sorted, values aligned)."""

    n: int
    idx: np.ndarray
    vals: np.ndarray

    @classmethod
    def from_dense(cls, x, keep_zeros: bool = False) -> "GrBVector":
        x = np.asarray(x)
        if keep_zeros:
            return cls(len(x), np.arange(len(x), dtype=INDEX), x.copy())
        nz = np.nonzero(x)[0]
        return cls(len(x), nz.astype(INDEX), x[nz])

    @classmethod
    def build(cls, n, idx, vals, dup: str = "plus") -> "GrBVector":
        idx = np.asarray(idx, dtype=INDEX)
        vals = np.asarray(vals)
        order = np.argsort(idx, kind="stable")
        idx, vals = idx[order], vals[order]
        uniq, start = np.unique(idx, return_index=True)
        folded = _dup_fold(vals, start, dup)
        return cls(int(n), uniq, folded)

    def to_dense(self, fill=0.0) -> np.ndarray:
        out = np.full(self.n, fill, dtype=np.result_type(self.vals, type(fill)))
        out[self.idx] = self.vals
        return out

    @property
    def nnz(self) -> int:
        return len(self.idx)

    def extract_tuples(self):
        return self.idx.copy(), self.vals.copy()


def _dup_fold(vals: np.ndarray, start: np.ndarray, dup: str) -> np.ndarray:
    """Fold runs of duplicate-index values with the dup binop
    (GrB_Matrix_build semantics; runs are contiguous after a stable sort)."""
    ufuncs = {"plus": np.add, "times": np.multiply, "min": np.minimum,
              "max": np.maximum}
    if dup in ufuncs:
        return ufuncs[dup].reduceat(vals, start) if len(vals) else vals
    if dup == "first":
        return vals[start]
    if dup in ("second", "any"):
        ends = np.r_[start[1:], len(vals)] - 1
        return vals[ends]
    raise SparseError(Status.INVALID, f"unknown dup op {dup!r}")


# ---------------------------------------------------------------------------
# Storage-format model (GxB_SPARSITY_CONTROL / GxB_FORMAT equivalents)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Storage:
    """Explicit storage realization of a matrix in one of the 8 variants.

    sparse/hypersparse: CSC or CSR arrays (hypersparse adds the list of
    nonempty major indices).  bitmap: dense values + presence mask.
    full: dense values, every entry present.  iso: True when all stored
    values are equal (value then in iso_value).
    """

    fmt: str
    orientation: str
    shape: tuple
    # sparse/hypersparse
    indptr: Optional[np.ndarray] = None
    indices: Optional[np.ndarray] = None
    data: Optional[np.ndarray] = None
    nonempty: Optional[np.ndarray] = None   # hypersparse h-list
    # bitmap/full
    dense: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    iso: bool = False
    iso_value: Optional[float] = None

    @property
    def nnz(self) -> int:
        if self.fmt == FULL:
            return int(np.prod(self.shape))
        if self.fmt == BITMAP:
            return int(self.mask.sum())
        return len(self.indices)


def realize(A: SparseCSC, fmt: str, orientation: str = BY_COL) -> Storage:
    """Convert a CSC container to an explicit storage variant."""
    if fmt not in FORMATS:
        raise SparseError(Status.INVALID, f"unknown format {fmt!r}")
    A = A.to_full_storage() if A.stype else A
    m, n = A.shape
    S = A.to_scipy()
    Sc = S.tocsc() if orientation == BY_COL else S.tocsr()
    Sc.sort_indices()
    data = Sc.data
    iso = bool(len(data)) and bool(np.all(data == data[0]))
    iso_value = float(np.real(data[0])) if iso and not np.iscomplexobj(data) \
        else (data[0] if iso else None)
    if fmt in (SPARSE, HYPERSPARSE):
        st = Storage(fmt=fmt, orientation=orientation, shape=(m, n),
                     indptr=Sc.indptr.astype(INDEX),
                     indices=Sc.indices.astype(INDEX), data=data,
                     iso=iso, iso_value=iso_value)
        if fmt == HYPERSPARSE:
            st.nonempty = np.nonzero(np.diff(Sc.indptr))[0].astype(INDEX)
        return st
    dense = np.asarray(S.toarray())
    if orientation == BY_ROW:
        dense = np.ascontiguousarray(dense)
    if fmt == BITMAP:
        mask = np.zeros((m, n), dtype=bool)
        r, c = S.nonzero()
        mask[r, c] = True
        return Storage(fmt=BITMAP, orientation=orientation, shape=(m, n),
                       dense=dense, mask=mask, iso=iso, iso_value=iso_value)
    return Storage(fmt=FULL, orientation=orientation, shape=(m, n),
                   dense=dense, iso=iso, iso_value=iso_value)


def to_csc(st: Storage) -> SparseCSC:
    """Any storage variant back to the CSC container."""
    import scipy.sparse as sp
    m, n = st.shape
    if st.fmt == FULL:
        return SparseCSC.from_scipy(sp.csc_matrix(st.dense))
    if st.fmt == BITMAP:
        d = np.where(st.mask, st.dense, 0.0)
        S = sp.csc_matrix(d)
        S.eliminate_zeros()
        # keep explicit zeros that the bitmap marks present
        r, c = np.nonzero(st.mask & (st.dense == 0))
        if len(r):
            S = (S + sp.csc_matrix((np.zeros(len(r)), (r, c)),
                                   shape=(m, n))).tocsc()
        return SparseCSC.from_scipy(S)
    if st.orientation == BY_COL:
        S = sp.csc_matrix((st.data, st.indices, st.indptr), shape=(m, n))
    else:
        S = sp.csr_matrix((st.data, st.indices, st.indptr),
                          shape=(m, n)).tocsc()
    return SparseCSC.from_scipy(S.tocsc())


def auto_format(A: SparseCSC, switch_bitmap: float = 0.10,
                switch_hyper: float = 0.0625) -> str:
    """The reference's sparsity-control heuristic (GB_convert.c policy,
    simplified): full if every entry present, bitmap if dense-ish
    (nnz/(m*n) > bitmap_switch), hypersparse if most columns empty
    (nonempty/n < hyper_switch), else sparse."""
    m, n = A.shape
    size = max(m * n, 1)
    nnz = A.nnz
    if nnz == size:
        return FULL
    if nnz / size > switch_bitmap:
        return BITMAP
    nonempty = int(np.count_nonzero(np.diff(A.indptr)))
    if n and nonempty / n < switch_hyper:
        return HYPERSPARSE
    return SPARSE


# ---------------------------------------------------------------------------
# Iterators (GxB_Iterator family)
# ---------------------------------------------------------------------------

class MatrixIterator:
    """GxB_Iterator: stateful entry/row/column traversal.

    kind='entry' yields (i, j, x) in storage order; kind='row' / 'col'
    yields (index, indices_array, values_array) per nonempty major vector
    (the GxB_rowIterator / GxB_colIterator protocols)."""

    def __init__(self, A, kind: str = "entry"):
        Ac = A if isinstance(A, SparseCSC) else A.to_csc()
        self.A = Ac.to_full_storage() if Ac.stype else Ac
        if kind not in ("entry", "row", "col"):
            raise SparseError(Status.INVALID, f"unknown iterator kind {kind!r}")
        self.kind = kind
        self._pos = 0
        if kind == "row":
            self._S = self.A.to_scipy().tocsr()
            self._major = np.nonzero(np.diff(self._S.indptr))[0]
        elif kind == "col":
            self._S = self.A.to_scipy().tocsc()
            self._major = np.nonzero(np.diff(self._S.indptr))[0]
        else:
            t = self.A.to_triplet()
            v = t.data if t.data is not None else np.ones(t.nnz)
            order = np.lexsort((t.row, t.col))
            self._entries = (t.row[order], t.col[order], v[order])

    def __iter__(self) -> Iterator:
        if self.kind == "entry":
            r, c, v = self._entries
            for t in range(len(r)):
                yield int(r[t]), int(c[t]), v[t]
        else:
            S = self._S
            for j in self._major:
                lo, hi = int(S.indptr[j]), int(S.indptr[j + 1])
                yield int(j), S.indices[lo:hi].copy(), S.data[lo:hi].copy()

    # stateful protocol (seek/next/get like GxB_Iterator_*)
    def seek(self, p: int) -> None:
        self._pos = int(p)

    def next(self):
        items = list(self) if not hasattr(self, "_cache") else self._cache
        self._cache = items
        if self._pos >= len(items):
            return None
        out = items[self._pos]
        self._pos += 1
        return out


def iterate_entries(A):
    """Convenience generator over (i, j, x)."""
    return iter(MatrixIterator(A, "entry"))
