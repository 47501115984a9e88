"""GraphBLAS-lite: sparse linear algebra over semirings, in PyTorch.

Counterpart of suitesparse_tpu/graphblas/core.py.  Any (monoid ⊕, binop
⊗) pair from the op catalog forms a semiring, executed as gather → ⊗ →
segment-⊕ on an explicit device.  Capabilities: mxv/vxm/mxm, eWiseAdd/
eWiseMult/eWiseUnion, apply, select, reduce, transpose, extract, assign,
build/extractTuples, kron, concat/split/reshape/sort, with masks and
accumulators.

Host containers are SparseCSC; the device form is COO triples (row, col,
val) as torch tensors with int64 indices.  Values keep their dtype:
integer semirings stay integer and bool stays bool.

Segment reductions follow ``jax.ops.segment_*``: an empty segment holds
0 (sum), 1 (prod), the dtype's lowest value (max) or highest value (min).
Float sums and products run over sorted segments (``torch.segment_reduce``)
so that they are deterministic; min, max and integer reductions, whose
result does not depend on the order, scatter.  Monoids with no native
reduction (bitwise and/or, user monoids) fold each segment left to right
from the identity, as the reference's per-entry loop does, but one
vectorized step per position within the segments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core.sparse import INDEX, SparseCSC, Triplet
from ..core.status import SparseError, Status
from ..utils.device import (default_dtype, device_of, resolve_device,
                            torch_dtype)


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

_NP_OF_TORCH = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NP_OF_TORCH[dtype])
    return np.dtype(dtype)


def _is_int(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex())


def _float_of(x: torch.Tensor) -> torch.Tensor:
    """x as an inexact type where JAX promotes an integer operand of a
    true division or a transcendental: int64 -> float64, narrower -> float32."""
    if not _is_int(x):
        return x
    return x.to(torch.float64 if x.dtype == torch.int64 else torch.float32)


def _weak_float(x: torch.Tensor) -> torch.Tensor:
    """x as it combines with a Python float (a JAX weak type): integer and
    bool tensors take the device's default float (float64 on the CPU,
    where the reference runs with x64, float32 on the card)."""
    if not _is_int(x):
        return x
    return x.to(torch.float64 if default_dtype(x.device) == np.float64
                else torch.float32)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Op catalog (GrB_BinaryOp / GrB_Monoid / GrB_Semiring equivalents)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Monoid:
    """GrB_Monoid: associative ⊕ with a TYPED identity.

    `identity_for(dtype)` gives the dtype-true identity (e.g. min over
    int32 = iinfo.max, lor over bool = False — NOT float casts), for a
    numpy or torch dtype; the ops keep the operand dtype end to end."""

    name: str
    op: Callable              # torch elementwise binary
    identity: object          # canonical identity (float form)
    segment_reduce: Callable  # (data, segment_ids, num_segments) -> tensor

    def identity_for(self, dtype):
        dt = np_dtype(dtype)
        if dt.kind == "b":
            return {"plus": False, "times": True, "min": True, "max": False,
                    "any": False, "lor": False, "land": True,
                    "eq": True, "xor": False}.get(self.name, False)
        if dt.kind in "iu":
            info = np.iinfo(dt)
            if self.name == "min":
                return info.max
            if self.name == "max":
                return info.min
            return dt.type(np.real(self.identity))
        return dt.type(self.identity)


_SCATTER = {"plus": "sum", "times": "prod", "min": "amin", "max": "amax"}


def _empty_fill(name: str, dtype):
    """What jax.ops.segment_<name> leaves in an empty segment."""
    dt = np_dtype(dtype)
    if name == "plus":
        return False if dt.kind == "b" else 0
    if name == "times":
        return True if dt.kind == "b" else 1
    if dt.kind == "b":
        return name == "min"
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return int(info.min if name == "max" else info.max)
    return -np.inf if name == "max" else np.inf


def segment_reduce(name: str, d: torch.Tensor, s: torch.Tensor, n: int,
                   indices_are_sorted: bool = False,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """jax.ops.segment_{sum,prod,min,max} over axis 0: (nnz, ...) data,
    (nnz,) segment ids in [0, n) -> (n, ...).  ``lengths`` (entries per
    segment) may be passed when the ids are sorted and it is known."""
    if name in ("plus", "times") and not _is_int(d) and d.shape[0]:
        if not indices_are_sorted:
            s, perm = torch.sort(s, stable=True)
            d = d[perm]
            lengths = None
        if lengths is None:
            lengths = torch.bincount(s, minlength=n)
        return torch.segment_reduce(d, "sum" if name == "plus" else "prod",
                                    lengths=lengths, axis=0, unsafe=True)
    out = torch.full((n, *d.shape[1:]), _empty_fill(name, d.dtype),
                     dtype=d.dtype, device=d.device)
    if not d.shape[0]:
        return out
    idx = s.view(-1, *([1] * (d.dim() - 1))).expand_as(d)
    return out.scatter_reduce_(0, idx, d, _SCATTER[name], include_self=True)


class _SegReduce:
    """A catalog monoid's segment reduction, (data, segment_ids,
    num_segments) -> tensor; the keywords say that the ids are sorted."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, d, s, n, indices_are_sorted=False, lengths=None):
        kw = dict(indices_are_sorted=indices_are_sorted, lengths=lengths)
        name = self.name
        if name == "any":
            name = "max"
        if name in _SCATTER:
            return segment_reduce(name, d, s, n, **kw)
        # dtype-true logical reductions: nonzero = true, result in the
        # input dtype (integer/bool semiring semantics, no float casts)
        nz = (d != 0).to(torch.int32)
        if name == "lor":
            return (segment_reduce("max", nz, s, n, **kw) > 0).to(d.dtype)
        if name == "land":
            return (segment_reduce("min", nz, s, n, **kw) > 0).to(d.dtype)
        if name == "lxor":
            return (segment_reduce("plus", nz, s, n, **kw) % 2).to(d.dtype)
        raise KeyError(name)


def _seg_fold(op, identity_of):
    """Segment fold for ops with no native segment reduction (e.g. bitwise
    AND/OR, user monoids): each segment is folded from the identity in
    index order, exactly as the reference's per-entry loop, with one
    vectorized step per position within the segments."""
    def red(d, s, n):
        acc = torch.full((n, *d.shape[1:]), identity_of(np_dtype(d.dtype)),
                         dtype=d.dtype, device=d.device)
        if not d.shape[0]:
            return acc
        ss, order = torch.sort(s, stable=True)
        counts = torch.bincount(ss, minlength=n)
        offs = torch.cumsum(counts, 0) - counts
        rank = torch.arange(len(ss), device=d.device) - offs[ss]
        by_rank = torch.sort(rank, stable=True).indices
        sizes = torch.bincount(rank).tolist()
        p = 0
        for size in sizes:
            idx = order[by_rank[p:p + size]]    # one entry of each segment
            p += size
            seg = s[idx]
            acc[seg] = op(acc[seg], d[idx])
        return acc
    return red


def _land_op(a, b):
    return ((a != 0) & (b != 0)).to(a.dtype)


def _lor_op(a, b):
    return ((a != 0) | (b != 0)).to(a.dtype)


def _lxor_op(a, b):
    return ((a != 0) ^ (b != 0)).to(a.dtype)


MONOIDS = {
    "plus": Monoid("plus", torch.add, 0.0, _SegReduce("plus")),
    "times": Monoid("times", torch.mul, 1.0, _SegReduce("times")),
    "min": Monoid("min", torch.minimum, np.inf, _SegReduce("min")),
    "max": Monoid("max", torch.maximum, -np.inf, _SegReduce("max")),
    "any": Monoid("any", lambda a, b: b, 0.0, _SegReduce("any")),
    "lor": Monoid("lor", _lor_op, 0.0, _SegReduce("lor")),
    "land": Monoid("land", _land_op, 1.0, _SegReduce("land")),
    "lxor": Monoid("lxor", _lxor_op, 0.0, _SegReduce("lxor")),
}
MONOIDS["band"] = Monoid(
    "band", torch.bitwise_and, -1,
    _seg_fold(torch.bitwise_and, lambda dt: np.dtype(dt).type(-1)
              if np.dtype(dt).kind == "i" else np.iinfo(dt).max))
MONOIDS["bor"] = Monoid(
    "bor", torch.bitwise_or, 0, _seg_fold(torch.bitwise_or, lambda dt: 0))


def _divide(a, b):
    """jnp.divide: true division; integer operands become inexact."""
    if torch.is_tensor(a) and torch.is_tensor(b) and _is_int(a) and _is_int(b):
        a, b = _float_of(a), _float_of(b)
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.true_divide(a, b)


BINOPS = {
    "times": torch.mul,
    "plus": torch.add,
    "minus": torch.sub,
    "rminus": lambda a, b: b - a,
    "div": _divide,
    "rdiv": lambda a, b: _divide(b, a),
    "first": lambda a, b: a,
    "second": lambda a, b: b,
    "min": torch.minimum,
    "max": torch.maximum,
    "land": _land_op,
    "lor": _lor_op,
    "lxor": _lxor_op,
    "band": torch.bitwise_and,
    "bor": torch.bitwise_or,
    "bxor": torch.bitwise_xor,
    "pair": lambda a, b: torch.ones_like(a),
    "eq": lambda a, b: (a == b).to(a.dtype),
    "ne": lambda a, b: (a != b).to(a.dtype),
    "gt": lambda a, b: (a > b).to(a.dtype),
    "lt": lambda a, b: (a < b).to(a.dtype),
    "ge": lambda a, b: (a >= b).to(a.dtype),
    "le": lambda a, b: (a <= b).to(a.dtype),
}

UNARYOPS = {
    "identity": lambda x: x,
    "ainv": torch.neg,
    "minv": lambda x: 1.0 / _weak_float(x),
    "abs": torch.abs,
    "lnot": lambda x: (x == 0).to(x.dtype),
    "bnot": torch.bitwise_not,
    "one": torch.ones_like,
    "sqrt": lambda x: torch.sqrt(_float_of(x)),
    "exp": lambda x: torch.exp(_float_of(x)),
    "log": lambda x: torch.log(_float_of(x)),
}


# -- user-defined op / semiring registration (GrB_BinaryOp_new /
#    GrB_Monoid_new / GrB_Semiring_new / GrB_UnaryOp_new equivalents) -------

def register_binop(name: str, fn: Callable) -> None:
    """GrB_BinaryOp_new: fn(a, b) over torch tensors, dtype-polymorphic."""
    if not callable(fn):
        raise SparseError(Status.INVALID, "binop must be callable")
    BINOPS[name] = fn


def register_unaryop(name: str, fn: Callable) -> None:
    """GrB_UnaryOp_new."""
    if not callable(fn):
        raise SparseError(Status.INVALID, "unaryop must be callable")
    UNARYOPS[name] = fn


def register_monoid(name: str, op: Callable, identity,
                    segment_reduce: Optional[Callable] = None) -> Monoid:
    """GrB_Monoid_new: ⊕ + identity (+ optional native segment reduction;
    the default folds each segment through ⊕ on the device)."""
    if segment_reduce is None:
        segment_reduce = _seg_fold(op, lambda dt: np.dtype(dt).type(identity))
    mon = Monoid(name, op, identity, segment_reduce)
    MONOIDS[name] = mon
    return mon


def register_semiring(name: str, monoid: Union[str, Monoid],
                      binop: Union[str, Callable]) -> "Semiring":
    """GrB_Semiring_new: any (monoid, binop) pair, catalog or user-defined."""
    add = MONOIDS[monoid] if isinstance(monoid, str) else monoid
    mult = BINOPS[binop] if isinstance(binop, str) else binop
    ring = Semiring(add, mult, name)
    SEMIRINGS[name] = ring
    return ring


SEMIRINGS: dict = {}


@dataclasses.dataclass(frozen=True)
class Semiring:
    """monoid ⊕ + binop ⊗ (GrB_Semiring).  Any catalog pair composes."""

    add: Monoid
    mult: Callable
    name: str


def semiring(name: str) -> Semiring:
    """'plus_times', 'min_plus', 'max_times', 'lor_land', ... any
    '<monoid>_<binop>' pair from the catalogs, or a name registered via
    register_semiring (user-defined ops included)."""
    if name in SEMIRINGS:
        return SEMIRINGS[name]
    addname, _, multname = name.partition("_")
    if addname not in MONOIDS or multname not in BINOPS:
        raise SparseError(Status.INVALID, f"unknown semiring {name!r}")
    return Semiring(MONOIDS[addname], BINOPS[multname], name)


def _reduce_sorted(mon: Monoid, d, s, n, lengths=None):
    """mon's segment reduction over ascending segment ids."""
    red = mon.segment_reduce
    if isinstance(red, _SegReduce):
        return red(d, s, n, indices_are_sorted=True, lengths=lengths)
    return red(d, s, n)


# ---------------------------------------------------------------------------
# Device matrix form
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GrBMatrix:
    """COO device form (+ host CSC mirror for structural ops)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple[int, int]
    # (perm, rows[perm], entries per row): the row-sorted order, made on
    # the host once per matrix
    _by_row: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    @classmethod
    def from_csc(cls, A: SparseCSC, device=None) -> "GrBMatrix":
        dev = resolve_device(device)
        t = A.to_full_storage().to_triplet() if A.stype else A.to_triplet()
        vals = t.data if t.data is not None else np.ones(t.nnz)
        return cls(torch.as_tensor(t.row, device=dev),
                   torch.as_tensor(t.col, device=dev),
                   torch.as_tensor(vals, device=dev), t.shape)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to_csc(self) -> SparseCSC:
        return Triplet(self.rows.cpu().numpy(), self.cols.cpu().numpy(),
                       self.vals.cpu().numpy(), self.shape).to_csc()

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def by_row(self):
        """(perm, sorted rows, entries per row) of the stable row sort."""
        if self._by_row is None:
            rows = self.rows.cpu().numpy()
            perm = np.argsort(rows, kind="stable")
            dev = self.device
            self._by_row = (
                torch.as_tensor(perm, device=dev),
                torch.as_tensor(rows[perm], device=dev),
                torch.as_tensor(np.bincount(rows, minlength=self.shape[0]),
                                device=dev))
        return self._by_row


def _as_grb(A, device=None) -> GrBMatrix:
    return A if isinstance(A, GrBMatrix) else GrBMatrix.from_csc(A, device)


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

def _vec_dense(x, n, dev):
    from .objects import GrBVector
    if isinstance(x, GrBVector):
        x = x.to_dense()
    return torch.as_tensor(x, device=dev)


def _where_scalar(md, y, v):
    """jnp.where(md, y, v) for a Python scalar v: v takes y's dtype, except
    that a float v lifts an integer or bool y as a JAX weak float does."""
    if isinstance(v, float):
        y = _weak_float(y)
    return torch.where(md, y, _scalar(v, y))


def _apply_mask_vec(y, mask, desc, y0, identity):
    """GrB output-mask semantics: keep masked entries; unmasked entries keep
    the prior output (or are cleared under GrB_REPLACE)."""
    if mask is None:
        return y
    md = torch.as_tensor(mask, device=y.device)
    if not getattr(desc, "mask_structure", False) and md.dtype != torch.bool:
        md = md != 0
    if getattr(desc, "mask_complement", False):
        md = ~md.to(torch.bool)
    md = md.to(torch.bool)
    if y0 is None or getattr(desc, "replace", False):
        return _where_scalar(md, y, identity)
    return torch.where(md, y, torch.as_tensor(y0, device=y.device))


def _dense_reduce(monoid_name):
    return {"plus": lambda t, axis: t.sum(axis),
            "min": lambda t, axis: t.amin(axis),
            "max": lambda t, axis: t.amax(axis),
            "times": lambda t, axis: t.prod(axis)}.get(
                monoid_name, lambda t, axis: t.sum(axis))


def mxv(A, x, ring: Union[str, Semiring] = "plus_times",
        mask: Optional[np.ndarray] = None,
        accum: Optional[str] = None, y0=None, desc=None, device=None):
    """y = A ⊕.⊗ x (GrB_mxv), a tensor on the device it ran on.  Sparse A
    runs as one gather/⊗/segment-⊕ program over its row-sorted entries;
    bitmap/full A runs the dense path.  desc: Descriptor (transpose0
    applies A'; mask complement/structure/replace per GrB_DESC semantics).
    Runs where A's (or x's) tensors live, else on ``device`` (None: the
    card)."""
    from .objects import Descriptor
    desc = desc or Descriptor()
    ring = semiring(ring) if isinstance(ring, str) else ring
    if desc.transpose0:
        return vxm(x, A, ring, mask=mask, accum=accum, y0=y0,
                   desc=dataclasses.replace(desc, transpose0=False),
                   device=device)
    dev = device_of(A, x, device=device)
    # dense storage path (bitmap/full): masked elementwise ⊗ then a row
    # reduction, no gathers
    from .objects import Storage, BITMAP, FULL
    if isinstance(A, Storage) and A.fmt in (BITMAP, FULL):
        m, n = A.shape
        xd = _vec_dense(x, n, dev)
        D = torch.as_tensor(A.dense, device=dev)
        t = ring.mult(D, xd[None, :])
        if A.fmt == BITMAP:
            t = torch.where(torch.as_tensor(A.mask, device=dev), t,
                            _scalar(ring.add.identity_for(t.dtype), t))
        y = _dense_reduce(ring.add.name)(t, 1)
    else:
        G = _as_grb(A, dev)
        m, n = G.shape
        xd = _vec_dense(x, n, dev)
        perm, rows, counts = G.by_row()
        terms = ring.mult(G.vals[perm], xd[G.cols[perm]])
        y = _reduce_sorted(ring.add, terms, rows, m, counts)
        # rows with no entries get the monoid identity -> GrB: empty
        y = torch.where(counts > 0, y,
                        _scalar(ring.add.identity_for(y.dtype), y))
    if accum is not None and y0 is not None:
        y = BINOPS[accum](torch.as_tensor(y0, device=dev), y)
    return _apply_mask_vec(y, mask, desc, y0, 0.0)


def vxm(x, A, ring="plus_times", device=None, **kw):
    """y' = x' ⊕.⊗ A  ==  mxv with A transposed."""
    from .objects import Storage
    if isinstance(A, Storage):
        A = _to_cscish(A)
    G = _as_grb(A, device_of(A, x, device=device))
    GT = GrBMatrix(G.cols, G.rows, G.vals, (G.shape[1], G.shape[0]))
    return mxv(GT, x, ring, **kw)


def _to_cscish(A) -> SparseCSC:
    from .objects import Storage, to_csc as _stc
    if isinstance(A, Storage):
        return _stc(A)
    return A.to_csc() if isinstance(A, GrBMatrix) else A


def _dense_mxm(A, B, ring, mask, desc, dev):
    """Format-driven dense path: both operands bitmap/full -> one dense
    product (plus_times) or a chunked elementwise reduce (general
    semirings); the result is a bitmap Storage."""
    from .objects import BITMAP, BY_ROW, Storage
    m, k = A.shape
    k2, n = B.shape
    Ad = torch.as_tensor(A.dense, device=dev)
    Bd = torch.as_tensor(B.dense, device=dev)
    Am = (torch.as_tensor(A.mask, device=dev) if A.fmt == BITMAP
          else torch.ones((m, k), dtype=torch.bool, device=dev))
    Bm = (torch.as_tensor(B.mask, device=dev) if B.fmt == BITMAP
          else torch.ones((k2, n), dtype=torch.bool, device=dev))
    if ring.name == "plus_times":
        C = _where_scalar(Am, Ad, 0.0) @ _where_scalar(Bm, Bd, 0.0)
        present = (Am.to(torch.float32) @ Bm.to(torch.float32)) > 0
    else:
        red = _dense_reduce(ring.add.name)
        ident = ring.add.identity_for(Ad.dtype)
        chunk = 64
        Cs, Ps = [], []
        for r0 in range(0, m, chunk):
            a, am = Ad[r0:r0 + chunk], Am[r0:r0 + chunk]   # (c, k), (c, k)
            T = ring.mult(a[:, :, None], Bd[None, :, :])
            P = am[:, :, None] & Bm[None, :, :]
            Cs.append(red(torch.where(P, T, _scalar(ident, T)), 1))
            Ps.append(P.any(dim=1))
        C = torch.cat(Cs) if Cs else Ad.new_zeros((0, n))
        present = torch.cat(Ps) if Ps else Am.new_zeros((0, n))
    if mask is not None:
        md = _dense_mask_of(mask, (m, n),
                            getattr(desc, "mask_complement", False), dev)
        present = present & md
    return Storage(fmt=BITMAP, orientation=BY_ROW, shape=(m, n),
                   dense=C.cpu().numpy(), mask=present.cpu().numpy())


def mxm(A, B, ring: Union[str, Semiring] = "plus_times",
        mask: Optional[SparseCSC] = None,
        accum: Optional[str] = None, C0: Optional[SparseCSC] = None,
        desc=None, device=None):
    """C = A ⊕.⊗ B (GrB_mxm).

    Sparse x sparse runs the Gustavson program (ops/spgemm.py: per-pattern
    expansion plan on the host + one gather/⊗/sorted-segment-⊕ program on
    the device) for EVERY catalog semiring; masks restrict the expansion at
    plan time.  bitmap/full x bitmap/full dispatches to the dense path and
    returns a bitmap Storage.  desc.transpose0/1 transpose the inputs;
    desc.mask_complement complements the mask pattern; accum folds into C0.
    The numeric work runs on ``device`` (None: the card)."""
    from .objects import Descriptor, Storage, BITMAP, FULL
    desc = desc or Descriptor()
    ring = semiring(ring) if isinstance(ring, str) else ring
    dev = device_of(A, B, device=device)
    if (isinstance(A, Storage) and A.fmt in (BITMAP, FULL)
            and isinstance(B, Storage) and B.fmt in (BITMAP, FULL)
            and not desc.transpose0 and not desc.transpose1
            and accum is None):
        return _dense_mxm(A, B, ring, mask, desc, dev)
    Ac = _to_cscish(A)
    Bc = _to_cscish(B)
    if desc.transpose0:
        Ac = Ac.transpose()
    if desc.transpose1:
        Bc = Bc.transpose()
    if accum is not None and C0 is not None:
        C = mxm(Ac, Bc, ring, mask=mask,
                desc=dataclasses.replace(desc, transpose0=False,
                                         transpose1=False), device=dev)
        return ewise_add(C0, C, op=accum, device=dev)
    from ..ops.spgemm import cached_plan, spgemm_apply
    plan = cached_plan(Ac, Bc, mask=mask,
                       complement=bool(mask is not None
                                       and desc.mask_complement))
    if plan.nnz == 0:
        from ..core.sparse import spzeros
        return spzeros(Ac.shape[0], Bc.shape[1])
    av = Ac.data if Ac.data is not None else np.ones(Ac.nnz)
    bv = Bc.data if Bc.data is not None else np.ones(Bc.nnz)
    vals = spgemm_apply(plan, av, bv, ring, device=dev).cpu().numpy()
    return Triplet(plan.out_rows, plan.out_cols, vals,
                   plan.shape).to_csc()


def _apply_mask_mat(C: SparseCSC, mask, desc) -> SparseCSC:
    """Output mask on a matrix result: keep entries where the mask pattern
    is present (or absent under GrB_COMP)."""
    if mask is None:
        return C
    from .objects import Descriptor
    desc = desc or Descriptor()
    import scipy.sparse as sp
    Sc = C.to_scipy().tocsc()
    if desc.mask_complement:
        # pattern difference via sorted key search — O(nnz log nnz), no
        # (m x n) dense complement
        t = C.to_triplet()
        mt = mask.to_triplet()
        mkeep = (np.ones(mt.nnz, dtype=bool) if mt.data is None
                 else mt.data != 0)
        n_ = C.shape[1]
        ckeys = t.row.astype(np.int64) * n_ + t.col
        mkeys = np.sort(mt.row[mkeep].astype(np.int64) * n_ + mt.col[mkeep])
        pos = np.searchsorted(mkeys, ckeys)
        posc = np.clip(pos, 0, max(len(mkeys) - 1, 0))
        inmask = (len(mkeys) > 0) & (mkeys[posc] == ckeys)
        keepm = ~inmask
        vals = (t.data[keepm] if t.data is not None else None)
        return Triplet(t.row[keepm], t.col[keepm], vals, C.shape).to_csc()
    keep = Sc.multiply(mask.to_scipy() != 0)
    return SparseCSC.from_scipy(sp.csc_matrix(keep))


def _dense_mask_of(mask, shape, complement, dev):
    """Device boolean mask for the dense paths: sparse masks scatter their
    COO pattern straight into the dense-sized result mask."""
    if isinstance(mask, SparseCSC):
        t = mask.to_triplet()
        keep = np.ones(t.nnz, bool) if t.data is None else (t.data != 0)
        md = torch.zeros(shape, dtype=torch.bool, device=dev)
        md[torch.as_tensor(t.row[keep], device=dev),
           torch.as_tensor(t.col[keep], device=dev)] = True
    else:
        md = torch.as_tensor(np.asarray(mask), device=dev) != 0
    return ~md if complement else md


def _both_dense(A, B):
    from .objects import Storage, BITMAP, FULL
    return (isinstance(A, Storage) and A.fmt in (BITMAP, FULL)
            and isinstance(B, Storage) and B.fmt in (BITMAP, FULL))


def _dense_ewise(A, B, op: str, mode: str, mask, desc, dev):
    """Format-driven dense eWise: bitmap/full operands combine as one
    elementwise program, result bitmap."""
    from .objects import BITMAP, BY_ROW, Storage
    m, n = A.shape
    fn = BINOPS[op]
    Ad = torch.as_tensor(A.dense, device=dev)
    Bd = torch.as_tensor(B.dense, device=dev)
    ones = torch.ones((m, n), dtype=torch.bool, device=dev)
    Am = torch.as_tensor(A.mask, device=dev) if A.fmt == BITMAP else ones
    Bm = torch.as_tensor(B.mask, device=dev) if B.fmt == BITMAP else ones
    both = Am & Bm
    if mode == "mult":
        P = both
        C = _where_scalar(P, fn(Ad, Bd), 0.0)
    else:
        C = torch.where(both, fn(Ad, Bd),
                        torch.where(Am, Ad, _where_scalar(Bm, Bd, 0.0)))
        P = Am | Bm
    if mask is not None:
        md = _dense_mask_of(mask, (m, n),
                            desc is not None
                            and getattr(desc, "mask_complement", False), dev)
        P = P & md
    return Storage(fmt=BITMAP, orientation=BY_ROW, shape=(m, n),
                   dense=C.cpu().numpy(), mask=P.cpu().numpy())


def _binop_host(fn, a: np.ndarray, b: np.ndarray, dev) -> np.ndarray:
    """A catalog binop on host arrays, computed on ``dev``."""
    return fn(torch.as_tensor(a, device=dev),
              torch.as_tensor(b, device=dev)).cpu().numpy()


def _union_values(Ac, Bc):
    """Union pattern of two CSC matrices: (rows, cols, a, b, ina, inb)."""
    SA, SB = Ac.to_scipy().tocsc(), Bc.to_scipy().tocsc()
    pat = ((SA != 0) + (SB != 0)).tocsc()
    rows, cols = pat.nonzero()
    a = np.asarray(SA[rows, cols]).ravel()
    b = np.asarray(SB[rows, cols]).ravel()
    ina = np.asarray((SA != 0)[rows, cols]).ravel()
    inb = np.asarray((SB != 0)[rows, cols]).ravel()
    return rows, cols, a, b, ina, inb


def ewise_add(A, B, op: str = "plus", mask=None, desc=None,
              device=None) -> SparseCSC:
    """GrB_eWiseAdd: set-union combine (+ optional output mask).
    bitmap/full operands run the dense path (bitmap result).  The binop
    runs on ``device`` (None: the card)."""
    dev = device_of(A, B, device=device)
    if _both_dense(A, B):
        return _dense_ewise(A, B, op, "add", mask, desc, dev)
    Ac = _to_cscish(A)
    Bc = _to_cscish(B)
    fn = BINOPS[op]
    rows, cols, a, b, ina, inb = _union_values(Ac, Bc)
    if len(rows) == 0:
        from ..core.sparse import spzeros
        return spzeros(*Ac.shape)
    vals = np.where(ina & inb, _binop_host(fn, a, b, dev),
                    np.where(ina, a, b))
    C = Triplet(rows.astype(INDEX), cols.astype(INDEX), vals,
                Ac.shape).to_csc()
    return _apply_mask_mat(C, mask, desc)


def ewise_mult(A, B, op: str = "times", mask=None, desc=None,
               device=None) -> SparseCSC:
    """GrB_eWiseMult: set-intersection combine (+ optional output mask).
    bitmap/full operands run the dense path (bitmap result)."""
    dev = device_of(A, B, device=device)
    if _both_dense(A, B):
        return _dense_ewise(A, B, op, "mult", mask, desc, dev)
    Ac = _to_cscish(A)
    Bc = _to_cscish(B)
    fn = BINOPS[op]
    SA, SB = Ac.to_scipy().tocsc(), Bc.to_scipy().tocsc()
    pat = ((SA != 0).multiply(SB != 0)).tocsc()
    rows, cols = pat.nonzero()
    if len(rows) == 0:
        from ..core.sparse import spzeros
        return spzeros(*Ac.shape)
    a = np.asarray(SA[rows, cols]).ravel()
    b = np.asarray(SB[rows, cols]).ravel()
    vals = _binop_host(fn, a, b, dev)
    C = Triplet(rows.astype(INDEX), cols.astype(INDEX), vals,
                Ac.shape).to_csc()
    return _apply_mask_mat(C, mask, desc)


def apply(A, op: Union[str, Callable], device=None) -> SparseCSC:
    """GrB_apply: elementwise unary op on stored values (on ``device``)."""
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    dev = device_of(A, device=device)
    fn = UNARYOPS[op] if isinstance(op, str) else op
    out = Ac.copy()
    out.data = fn(torch.as_tensor(out.data, device=dev)).cpu().numpy()
    return out


def select(A, pred: Union[str, Callable], thunk: float = 0.0) -> SparseCSC:
    """GrB_select: keep entries satisfying a predicate.  Named predicates:
    tril, triu, diag, offdiag, nonzero, gt, lt, ge, le, eq, ne."""
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    t = Ac.to_triplet()
    v = t.data if t.data is not None else np.ones(t.nnz)
    named = {
        "tril": lambda: t.row >= t.col + thunk if thunk else t.row >= t.col,
        "triu": lambda: t.row <= t.col,
        "diag": lambda: t.row == t.col,
        "offdiag": lambda: t.row != t.col,
        "nonzero": lambda: v != 0,
        "gt": lambda: v > thunk,
        "ge": lambda: v >= thunk,
        "lt": lambda: v < thunk,
        "le": lambda: v <= thunk,
        "eq": lambda: v == thunk,
        "ne": lambda: v != thunk,
    }
    keep = named[pred]() if isinstance(pred, str) else pred(t.row, t.col, v)
    return Triplet(t.row[keep], t.col[keep],
                   None if t.data is None else t.data[keep], t.shape).to_csc()


def reduce_rows(A, monoid: str = "plus", device=None):
    """GrB_reduce to a vector (row-wise ⊕), a tensor on the device."""
    G = _as_grb(A, device)
    mon = MONOIDS[monoid]
    perm, rows, counts = G.by_row()
    out = _reduce_sorted(mon, G.vals[perm], rows, G.shape[0], counts)
    return torch.where(counts > 0, out,
                       _scalar(mon.identity_for(out.dtype), out))


def reduce_scalar(A, monoid: str = "plus", device=None):
    """GrB_reduce to a scalar (any catalog or registered monoid), a 0-d
    tensor on the device."""
    G = _as_grb(A, device)
    mon = MONOIDS[monoid]
    if not G.nnz:
        # a Python identity, as JAX's weak type: floats in the device's
        # default float type
        dt = (torch_dtype(default_dtype(G.device))
              if isinstance(mon.identity, float) else None)
        return torch.as_tensor(mon.identity, dtype=dt, device=G.device)
    red = {"plus": torch.sum, "min": torch.amin, "max": torch.amax,
           "times": torch.prod}.get(mon.name)
    if red is not None:
        return red(G.vals)
    # generic: one-segment fold through the monoid's own reduction
    return mon.segment_reduce(
        G.vals, torch.zeros(G.nnz, dtype=torch.int64, device=G.device),
        1)[0]


def transpose(A) -> SparseCSC:
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    return Ac.transpose()


def kron(A, B, op: str = "times", device=None) -> SparseCSC:
    """GrB_kronecker (the binop on ``device``)."""
    dev = device_of(A, B, device=device)
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    Bc = B.to_csc() if isinstance(B, GrBMatrix) else B
    ta, tb = Ac.to_triplet(), Bc.to_triplet()
    mb, nb = Bc.shape
    rows = (ta.row[:, None] * mb + tb.row[None, :]).ravel()
    cols = (ta.col[:, None] * nb + tb.col[None, :]).ravel()
    fn = BINOPS[op]
    vals = _binop_host(fn, np.repeat(ta.data, tb.nnz),
                       np.tile(tb.data, ta.nnz), dev)
    return Triplet(rows, cols, vals,
                   (Ac.shape[0] * mb, Ac.shape[1] * nb)).to_csc()


def build(rows, cols, vals, shape, dup: str = "plus") -> SparseCSC:
    """GrB_Matrix_build: duplicates folded with the dup binop
    (plus/times/min/max/first/second/any)."""
    rows = np.asarray(rows, dtype=INDEX)
    cols = np.asarray(cols, dtype=INDEX)
    vals = np.asarray(vals)
    if dup == "plus":
        return Triplet(rows, cols, vals, shape).to_csc()
    from .objects import _dup_fold
    key = cols.astype(np.int64) * shape[0] + rows
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq, start = np.unique(key, return_index=True)
    folded = _dup_fold(vals, start, dup)
    return Triplet(rows[start], cols[start], folded, shape).to_csc()


def extract_tuples(A) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GrB_Matrix_extractTuples."""
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    t = Ac.to_triplet()
    return t.row, t.col, t.data


def extract(A, rows, cols) -> SparseCSC:
    """GrB_extract: C = A(rows, cols)."""
    from ..core.sparse import submatrix
    Ac = A.to_csc() if isinstance(A, GrBMatrix) else A
    return submatrix(Ac, rows, cols)


def assign(A, rows, cols, B) -> SparseCSC:
    """GrB_assign: C(rows, cols) = B."""
    Ac = (A.to_csc() if isinstance(A, GrBMatrix) else A).to_scipy().tolil()
    Bc = (B.to_csc() if isinstance(B, GrBMatrix) else B).to_scipy()
    Ac[np.ix_(np.asarray(rows), np.asarray(cols))] = Bc
    return SparseCSC.from_scipy(Ac.tocsc())


def ewise_union(A, B, op: str = "plus", alpha: float = 0.0,
                beta: float = 0.0, mask=None, desc=None,
                device=None) -> SparseCSC:
    """GxB_eWiseUnion: like eWiseAdd but entries present in only one input
    are combined with the other operand's fill scalar (alpha for missing A,
    beta for missing B) instead of passing through unchanged."""
    dev = device_of(A, B, device=device)
    Ac = _to_cscish(A)
    Bc = _to_cscish(B)
    fn = BINOPS[op]
    rows, cols, a, b, ina, inb = _union_values(Ac, Bc)
    if len(rows) == 0:
        from ..core.sparse import spzeros
        return spzeros(*Ac.shape)
    a = np.where(ina, a, alpha)
    b = np.where(inb, b, beta)
    vals = _binop_host(fn, a, b, dev)
    C = Triplet(rows.astype(INDEX), cols.astype(INDEX), vals,
                Ac.shape).to_csc()
    return _apply_mask_mat(C, mask, desc)


def concat(tiles) -> SparseCSC:
    """GxB_Matrix_concat: C = [[tiles]] from a 2D list-of-lists of
    matrices (row-major tile grid)."""
    import scipy.sparse as sp
    rows = []
    for tile_row in tiles:
        rows.append(sp.hstack([_to_cscish(t).to_scipy() for t in tile_row],
                              format="csc"))
    return SparseCSC.from_scipy(sp.vstack(rows, format="csc"))


def split(A, row_sizes, col_sizes):
    """GxB_Matrix_split: partition A into a tile grid with the given row
    and column block sizes; returns a 2D list-of-lists."""
    Ac = _to_cscish(A)
    if sum(row_sizes) != Ac.nrow or sum(col_sizes) != Ac.ncol:
        raise SparseError(Status.INVALID, "split sizes must sum to shape")
    S = Ac.to_scipy().tocsc()
    out = []
    r0 = 0
    for rs in row_sizes:
        tile_row = []
        c0 = 0
        for cs in col_sizes:
            tile_row.append(SparseCSC.from_scipy(
                S[r0:r0 + rs, c0:c0 + cs].tocsc()))
            c0 += cs
        out.append(tile_row)
        r0 += rs
    return out


def reshape(A, nrow: int, ncol: int, by_col: bool = True) -> SparseCSC:
    """GxB_Matrix_reshape: same entries reinterpreted in a nrow-by-ncol
    shape (column-major by default, matching the reference)."""
    Ac = _to_cscish(A)
    if nrow * ncol != Ac.nrow * Ac.ncol:
        raise SparseError(Status.INVALID, "reshape must preserve size")
    r, c, v = extract_tuples(Ac)
    if by_col:
        lin = c.astype(np.int64) * Ac.nrow + r
        nr, nc = lin % nrow, lin // nrow
    else:
        lin = r.astype(np.int64) * Ac.ncol + c
        nr, nc = lin // ncol, lin % ncol
    return Triplet(nr.astype(INDEX), nc.astype(INDEX), v,
                   (nrow, ncol)).to_csc()


def sort(A, op: str = "lt", by_col: bool = True):
    """GxB_Matrix_sort: sort the entries within each column (or row) by
    value; returns (C, P) where C holds the sorted values compacted to the
    top of each column and P the original row (resp. column) indices."""
    Ac = _to_cscish(A)
    S = Ac.to_scipy().tocsc() if by_col else Ac.to_scipy().tocsr()
    indptr = S.indptr
    vals = S.data.copy()
    perm_idx = S.indices.astype(INDEX).copy()
    descending = op in ("gt", "max")
    for j in range(len(indptr) - 1):
        lo, hi = indptr[j], indptr[j + 1]
        order = np.argsort(vals[lo:hi], kind="stable")
        if descending:
            order = order[::-1]
        vals[lo:hi] = vals[lo:hi][order]
        perm_idx[lo:hi] = perm_idx[lo:hi][order]
    nvec = len(indptr) - 1
    counts = np.diff(indptr)
    # compacted: entry k of vector j sits at position k (dense-top layout)
    rows = (np.concatenate([np.arange(c) for c in counts]) if len(counts)
            else np.empty(0, INDEX))
    cols = np.repeat(np.arange(nvec), counts)
    if by_col:
        C = Triplet(rows.astype(INDEX), cols.astype(INDEX), vals,
                    Ac.shape).to_csc()
        P = Triplet(rows.astype(INDEX), cols.astype(INDEX),
                    perm_idx.astype(np.float64), Ac.shape).to_csc()
    else:
        C = Triplet(cols.astype(INDEX), rows.astype(INDEX), vals,
                    Ac.shape).to_csc()
        P = Triplet(cols.astype(INDEX), rows.astype(INDEX),
                    perm_idx.astype(np.float64), Ac.shape).to_csc()
    return C, P
