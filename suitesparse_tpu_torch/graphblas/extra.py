"""GraphBLAS breadth pass: positional ops, the IndexUnaryOp family, and
GxB pack/unpack import/export parity.  Counterpart of
suitesparse_tpu/graphblas/extra.py.

Reference surface targeted (GraphBLAS/Include/GraphBLAS.h):
  * positional binary ops GxB_FIRSTI/FIRSTI1/FIRSTJ/FIRSTJ1 and
    SECONDI/SECONDI1/SECONDJ/SECONDJ1 (:~2600) and the semirings built on
    them (min_firsti etc., used for BFS parent / argmin trees);
  * GrB_IndexUnaryOp (:~3000): ROWINDEX/COLINDEX/DIAGINDEX value ops and
    the TRIL/TRIU/DIAG/OFFDIAG/COLLE/COLGT/ROWLE/ROWGT + VALUE* predicate
    ops, usable through both GrB_apply and GrB_select;
  * GxB pack/unpack (:~5600): O(1)-intent container import/export in
    CSC/CSR/COO/bitmap/full forms (we validate + wrap the caller's arrays;
    "move" semantics are documented, not enforced — numpy owns storage).

Design note: positional SEMIRINGS reduce to the plain first/second
multiply with INDEX-VALUED operands: firsti substitutes A's values by
their row index (+1 for the I1 forms), secondj substitutes B's values by
their column index, etc.  That turns every positional semiring into an
ordinary catalog semiring — no index plumbing through the multiply
kernels (the reference generates dedicated positional kernel variants
instead).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core.sparse import INDEX, SparseCSC, Triplet
from ..core.status import SparseError, Status
from .core import GrBMatrix, mxm, mxv, semiring as _semiring

__all__ = [
    "POSITIONAL_BINOPS", "positional_mxm", "positional_mxv",
    "INDEXUNARY_OPS", "apply_indexop", "select_indexop",
    "pack_csc", "unpack_csc", "pack_csr", "unpack_csr",
    "pack_coo", "unpack_coo", "pack_full", "unpack_full",
    "pack_bitmap", "unpack_bitmap",
]

# positional binary multiply ops: name -> (which operand carries the
# index, which index, offset).  "first" ops read the A entry's indices,
# "second" ops the B entry's (GraphBLAS.h GxB_FIRSTI..SECONDJ1).
POSITIONAL_BINOPS = {
    "firsti":   ("A", "row", 0),
    "firsti1":  ("A", "row", 1),
    "firstj":   ("A", "col", 0),
    "firstj1":  ("A", "col", 1),
    "secondi":  ("B", "row", 0),
    "secondi1": ("B", "row", 1),
    "secondj":  ("B", "col", 0),
    "secondj1": ("B", "col", 1),
}


def _subst_positional(A, B, mult: str, device=None):
    """Substitute index values into the positional operand and return
    (A', B', plain_mult_name)."""
    side, which, off = POSITIONAL_BINOPS[mult]
    G = A if side == "A" else B
    G = G if isinstance(G, GrBMatrix) else GrBMatrix.from_csc(G, device)
    idx = G.rows if which == "row" else G.cols
    G2 = GrBMatrix(rows=G.rows, cols=G.cols,
                   vals=(idx + off).to(torch.int64), shape=G.shape)
    plain = "first" if side == "A" else "second"
    if side == "A":
        return G2, B, plain
    return A, G2, plain


def _split_ring(ring: str):
    addname, _, multname = ring.partition("_")
    return addname, multname


def positional_mxm(A, B, ring: str = "min_firsti", device=None,
                   **kw) -> SparseCSC:
    """mxm over a positional semiring ('<monoid>_<positional-op>'), e.g.
    min_firsti (argmin row index), any_secondj.  Returns int64 values; the
    numeric work runs on ``device`` (None: the card)."""
    addname, multname = _split_ring(ring)
    if multname not in POSITIONAL_BINOPS:
        raise SparseError(Status.INVALID,
                          f"not a positional semiring: {ring!r}")
    A2, B2, plain = _subst_positional(A, B, multname, device)
    return mxm(A2, B2, _semiring(f"{addname}_{plain}"), device=device, **kw)


def positional_mxv(A, x, ring: str = "min_firsti", device=None, **kw):
    """mxv over a positional semiring.  For 'first*' ops the positional
    value comes from A (the only indexed operand in mxv)."""
    addname, multname = _split_ring(ring)
    if multname not in POSITIONAL_BINOPS:
        raise SparseError(Status.INVALID,
                          f"not a positional semiring: {ring!r}")
    side, which, off = POSITIONAL_BINOPS[multname]
    if side != "A":
        raise SparseError(Status.INVALID,
                          "second* positional ops need the vector's index; "
                          "use firsti/firstj forms for mxv")
    A2, _, plain = _subst_positional(A, None, multname, device)
    return mxv(A2, x, _semiring(f"{addname}_{plain}"), **kw)


# ---------------------------------------------------------------------------
# GrB_IndexUnaryOp family: f(a_ij, i, j, thunk)
# ---------------------------------------------------------------------------

INDEXUNARY_OPS = {
    # value-producing (GrB_apply): int64 results
    "rowindex":  lambda v, i, j, y: i + y,
    "colindex":  lambda v, i, j, y: j + y,
    "diagindex": lambda v, i, j, y: j - i + y,
    # structural predicates (GrB_select)
    "tril":      lambda v, i, j, y: j <= i + y,
    "triu":      lambda v, i, j, y: j >= i + y,
    "diag":      lambda v, i, j, y: j == i + y,
    "offdiag":   lambda v, i, j, y: j != i + y,
    "colle":     lambda v, i, j, y: j <= y,
    "colgt":     lambda v, i, j, y: j > y,
    "rowle":     lambda v, i, j, y: i <= y,
    "rowgt":     lambda v, i, j, y: i > y,
    # value predicates
    "valueeq":   lambda v, i, j, y: v == y,
    "valuene":   lambda v, i, j, y: v != y,
    "valuelt":   lambda v, i, j, y: v < y,
    "valuele":   lambda v, i, j, y: v <= y,
    "valuegt":   lambda v, i, j, y: v > y,
    "valuege":   lambda v, i, j, y: v >= y,
}


def _index_triplet(A):
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    t = (Ac.to_full_storage() if Ac.stype else Ac).to_triplet()
    v = t.data if t.data is not None else np.ones(t.nnz)
    return t, v


def apply_indexop(A, op: Union[str, Callable], thunk=0) -> SparseCSC:
    """GrB_apply with a GrB_IndexUnaryOp: z_ij = f(a_ij, i, j, thunk).
    Value ops (rowindex/...) produce int64; predicate ops produce bool
    stored as int8 (GrB_BOOL)."""
    t, v = _index_triplet(A)
    fn = INDEXUNARY_OPS[op] if isinstance(op, str) else op
    z = np.asarray(fn(v, t.row.astype(np.int64), t.col.astype(np.int64),
                      thunk))
    if z.dtype == bool:
        z = z.astype(np.int8)
    return Triplet(t.row, t.col, z, t.shape).to_csc()


def select_indexop(A, op: Union[str, Callable], thunk=0) -> SparseCSC:
    """GrB_select with a GrB_IndexUnaryOp: keep entries where
    f(a_ij, i, j, thunk) is true."""
    t, v = _index_triplet(A)
    fn = INDEXUNARY_OPS[op] if isinstance(op, str) else op
    keep = np.asarray(fn(v, t.row.astype(np.int64),
                         t.col.astype(np.int64), thunk)).astype(bool)
    return Triplet(t.row[keep], t.col[keep],
                   None if t.data is None else t.data[keep],
                   t.shape).to_csc()


# ---------------------------------------------------------------------------
# GxB pack/unpack import/export
# ---------------------------------------------------------------------------

def pack_csc(nrow: int, ncol: int, indptr: np.ndarray, indices: np.ndarray,
             values: Optional[np.ndarray], jumbled: bool = False
             ) -> SparseCSC:
    """GxB_Matrix_pack_CSC: adopt caller arrays as a matrix (O(nnz) only
    when jumbled — rows are then sorted in place per column)."""
    indptr = np.ascontiguousarray(indptr, dtype=INDEX)
    indices = np.ascontiguousarray(indices, dtype=INDEX)
    if len(indptr) != ncol + 1 or indptr[0] != 0:
        raise SparseError(Status.INVALID, "pack_csc: bad indptr")
    if indptr[-1] != len(indices):
        raise SparseError(Status.INVALID, "pack_csc: indptr/indices "
                          "disagree on nnz")
    A = SparseCSC(indptr, indices, values, (nrow, ncol))
    if jumbled:
        A.sort_indices()
    return A


def unpack_csc(A: SparseCSC):
    """GxB_Matrix_unpack_CSC: export (indptr, indices, values); the matrix
    should be considered emptied by the caller (move semantics)."""
    if A.stype:
        A = A.to_full_storage()
    return A.indptr, A.indices, A.data


def pack_csr(nrow: int, ncol: int, indptr, indices, values,
             jumbled: bool = False) -> SparseCSC:
    """GxB_Matrix_pack_CSR: CSR arrays adopt as the transpose's CSC."""
    At = pack_csc(ncol, nrow, indptr, indices, values, jumbled)
    return At.transpose(values is not None)


def unpack_csr(A: SparseCSC):
    At = (A.to_full_storage() if A.stype else A).transpose(
        A.data is not None)
    At.sort_indices()
    return At.indptr, At.indices, At.data


def pack_coo(nrow: int, ncol: int, rows, cols, values,
             dup: str = "plus") -> SparseCSC:
    """GxB pack from COO triples (build semantics; duplicates folded)."""
    from .core import build
    return build(np.asarray(rows), np.asarray(cols),
                 None if values is None else np.asarray(values),
                 (nrow, ncol), dup=dup)


def unpack_coo(A: SparseCSC):
    t = (A.to_full_storage() if A.stype else A).to_triplet()
    return t.row, t.col, t.data


def pack_full(dense: np.ndarray) -> SparseCSC:
    """GxB_Matrix_pack_FullC: every entry present (column-major values)."""
    dense = np.asarray(dense)
    nrow, ncol = dense.shape
    indptr = np.arange(ncol + 1, dtype=INDEX) * nrow
    indices = np.tile(np.arange(nrow, dtype=INDEX), ncol)
    return SparseCSC(indptr, indices, dense.reshape(-1, order="F").copy(),
                     (nrow, ncol))


def unpack_full(A: SparseCSC) -> np.ndarray:
    Ac = A.to_full_storage() if A.stype else A
    if Ac.nnz != Ac.nrow * Ac.ncol:
        raise SparseError(Status.INVALID, "unpack_full: matrix not full")
    out = np.empty((Ac.nrow, Ac.ncol), dtype=Ac.data.dtype)
    for j in range(Ac.ncol):
        lo, hi = Ac.indptr[j], Ac.indptr[j + 1]
        out[Ac.indices[lo:hi], j] = Ac.data[lo:hi]
    return out


def pack_bitmap(bitmap: np.ndarray, values: np.ndarray) -> SparseCSC:
    """GxB_Matrix_pack_BitmapC: (nrow, ncol) presence bitmap + dense
    values (column-major)."""
    bitmap = np.asarray(bitmap, dtype=bool)
    values = np.asarray(values)
    r, c = np.nonzero(bitmap.T)          # column-major order
    return Triplet(c.astype(INDEX), r.astype(INDEX),
                   values[c, r] if values.ndim == 2
                   else values.reshape(bitmap.shape, order="F")[c, r],
                   bitmap.shape).to_csc()


def unpack_bitmap(A: SparseCSC):
    Ac = A.to_full_storage() if A.stype else A
    bitmap = np.zeros((Ac.nrow, Ac.ncol), dtype=bool)
    values = np.zeros((Ac.nrow, Ac.ncol),
                      dtype=Ac.data.dtype if Ac.data is not None
                      else np.float64)
    col = np.repeat(np.arange(Ac.ncol, dtype=INDEX), np.diff(Ac.indptr))
    bitmap[Ac.indices, col] = True
    if Ac.data is not None:
        values[Ac.indices, col] = Ac.data
    else:
        values[Ac.indices, col] = 1.0
    return bitmap, values
