"""Device SpGEMM over arbitrary semirings: Gustavson expansion -> sorted
segment reduce.  Counterpart of suitesparse_tpu/ops/spgemm.py.

Everything irregular — the expansion index arithmetic, the output pattern,
the sort — happens ONCE per (pattern(A), pattern(B)[, mask]) on the host
with numpy (the plan is the reference's, copied); the numeric product is
then one gather/⊗/segment-⊕ program on the device:

    terms = mult(Avals[ea], Bvals[eb])        # two gathers + one op
    Cvals = segment_reduce(terms, seg, nnzC)  # sorted segment-monoid

so ANY (monoid, binop) pair from the catalog runs on the device, and
refactor-style value changes reuse the plan and its device index maps.

The masked variant (C<M> = A op.op B) intersects the expansion with the
mask pattern at plan time, so e.g. triangle counting touches only the
entries it keeps.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from ..core.sparse import INDEX, SparseCSC
from ..utils.device import device_of

__all__ = ["SpGEMMPlan", "spgemm_plan", "spgemm_apply", "spgemm",
           "pattern_key"]


# -- sorted segment reductions per monoid -------------------------------------

def _seg_sorted(name: str):
    """(data, ascending segment ids, num_segments, lengths) -> tensor for
    a catalog monoid name; registered/user monoids fold through their own
    reduction (which ignores the lengths)."""
    from ..graphblas.core import MONOIDS, _SegReduce
    if name in ("plus", "times", "min", "max", "any", "lor", "land", "lxor"):
        red = _SegReduce(name)
        return lambda d, s, n, lengths=None: red(
            d, s, n, indices_are_sorted=True, lengths=lengths)
    if name in MONOIDS:
        red = MONOIDS[name].segment_reduce
        return lambda d, s, n, lengths=None: red(d, s, n)
    raise KeyError(name)


# -- plan ----------------------------------------------------------------------

@dataclasses.dataclass
class SpGEMMPlan:
    """Static per-pattern product program (host arrays + device mirrors)."""

    ea: np.ndarray        # (F,) gather into A.data (CSC data order)
    eb: np.ndarray        # (F,) gather into B.data (CSC data order)
    seg: np.ndarray       # (F,) output segment per term, ascending
    out_rows: np.ndarray  # (nnzC,)
    out_cols: np.ndarray  # (nnzC,)
    nnz: int
    shape: tuple
    flops: int            # multiply count F

    # device -> (ea, eb, seg, terms per output entry), uploaded once each
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def device_maps(self, device: torch.device):
        key = str(device)
        maps = self._dev.get(key)
        if maps is None:
            maps = (torch.as_tensor(self.ea, device=device),
                    torch.as_tensor(self.eb, device=device),
                    torch.as_tensor(self.seg, device=device),
                    torch.as_tensor(np.bincount(self.seg,
                                                minlength=self.nnz),
                                    device=device))
            self._dev[key] = maps
        return maps


def spgemm_plan(A: SparseCSC, B: SparseCSC,
                mask: Optional[SparseCSC] = None,
                complement: bool = False) -> SpGEMMPlan:
    """Build the static product program for C = A·B (patterns only).

    With `mask`, the expansion is restricted to (complemented) mask
    positions at plan time; C's pattern is then a subset of the mask."""
    m, ka = A.shape
    kb, n = B.shape
    if ka != kb:
        from ..core.status import SparseError, Status
        raise SparseError(Status.INVALID,
                          f"spgemm shape mismatch {A.shape} x {B.shape}")
    nnzA = A.nnz
    # A entries in CSC data order
    ar = np.asarray(A.indices, dtype=np.int64)
    ac = np.repeat(np.arange(ka, dtype=np.int64), np.diff(A.indptr))
    # B rows with CSC data positions: CSR of position values
    import scipy.sparse as sp
    SBpos = sp.csc_matrix(
        (np.arange(B.nnz, dtype=np.int64), np.asarray(B.indices),
         np.asarray(B.indptr)), shape=B.shape).tocsr()
    brp = SBpos.indptr.astype(np.int64)
    bcols = SBpos.indices.astype(np.int64)
    bpos = SBpos.data
    # expansion: A entry t=(i,k) x every entry (k,j) of B row k
    cnt = brp[ac + 1] - brp[ac]
    F = int(cnt.sum())
    if F == 0:
        z = np.empty(0, np.int64)
        return SpGEMMPlan(z, z, z, z.astype(INDEX), z.astype(INDEX), 0,
                          (m, n), 0)
    ea = np.repeat(np.arange(nnzA, dtype=np.int64), cnt)
    off = np.zeros(nnzA + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    within = np.arange(F, dtype=np.int64) - off[ea]
    t = brp[ac[ea]] + within
    eb = bpos[t]
    key = ar[ea] * n + bcols[t]
    if mask is not None:
        mr = np.asarray(mask.indices, dtype=np.int64)
        mc = np.repeat(np.arange(mask.shape[1], dtype=np.int64),
                       np.diff(mask.indptr))
        mkeys = np.sort(mr * n + mc)
        pos = np.searchsorted(mkeys, key)
        pos = np.minimum(pos, len(mkeys) - 1) if len(mkeys) else pos
        hit = (mkeys[pos] == key) if len(mkeys) else np.zeros(F, dtype=bool)
        keep = ~hit if complement else hit
        ea, eb, key = ea[keep], eb[keep], key[keep]
        F = len(key)
        if F == 0:
            z = np.empty(0, np.int64)
            return SpGEMMPlan(z, z, z, z.astype(INDEX), z.astype(INDEX), 0,
                              (m, n), 0)
    order = np.argsort(key, kind="stable")
    ea, eb, key = ea[order], eb[order], key[order]
    newseg = np.empty(F, dtype=bool)
    newseg[0] = True
    np.not_equal(key[1:], key[:-1], out=newseg[1:])
    seg = np.cumsum(newseg) - 1
    ukey = key[newseg]
    return SpGEMMPlan(ea=ea, eb=eb, seg=seg,
                      out_rows=(ukey // n).astype(INDEX),
                      out_cols=(ukey % n).astype(INDEX),
                      nnz=len(ukey), shape=(m, n), flops=F)


def _spgemm_device(avals, bvals, maps, mult_name, monoid_name, nnz):
    from ..graphblas.core import BINOPS
    ea, eb, seg, lengths = maps
    terms = BINOPS[mult_name](avals[ea], bvals[eb])
    return _seg_sorted(monoid_name)(terms, seg, nnz, lengths)


def spgemm_apply(plan: SpGEMMPlan, avals, bvals, ring,
                 device=None) -> torch.Tensor:
    """Numeric product on the device: C values for the plan's pattern, a
    tensor.  `ring` is a graphblas Semiring (or its name).  Runs where
    `avals` lives when it is a tensor, else on ``device`` (None: the
    card)."""
    from ..graphblas.core import semiring
    if isinstance(ring, str):
        ring = semiring(ring)
    dev = device_of(avals, device=device)
    avals = torch.as_tensor(avals, device=dev)
    bvals = torch.as_tensor(bvals, device=dev)
    if plan.nnz == 0:
        return torch.empty(0, dtype=torch.promote_types(avals.dtype,
                                                        bvals.dtype),
                           device=dev)
    mult_name, monoid_name = ring.name.partition("_")[2], ring.add.name
    return _spgemm_device(avals, bvals, plan.device_maps(dev), mult_name,
                          monoid_name, plan.nnz)


# -- plan cache ----------------------------------------------------------------

def pattern_key(A: SparseCSC) -> bytes:
    """Cheap pattern fingerprint (values excluded)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(A.indptr).tobytes())
    h.update(np.asarray(A.indices).tobytes())
    h.update(repr(A.shape).encode())
    return h.digest()


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64


def cached_plan(A: SparseCSC, B: SparseCSC, mask=None,
                complement: bool = False) -> SpGEMMPlan:
    key = (pattern_key(A), pattern_key(B),
           None if mask is None else pattern_key(mask), complement)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = spgemm_plan(A, B, mask=mask, complement=complement)
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = plan
    return plan


def spgemm(A: SparseCSC, B: SparseCSC, ring="plus_times", mask=None,
           complement: bool = False, device=None) -> SparseCSC:
    """One-call C = A ⊕.⊗ B with plan caching (pattern-stable programs
    reuse their plan and device maps; value changes rerun the product).
    The numeric product runs on ``device`` (None: the card)."""
    from ..core.sparse import Triplet
    plan = cached_plan(A, B, mask=mask, complement=complement)
    av = A.data if A.data is not None else np.ones(A.nnz)
    bv = B.data if B.data is not None else np.ones(B.nnz)
    vals = spgemm_apply(plan, av, bv, ring, device=device).cpu().numpy()
    return Triplet(plan.out_rows, plan.out_cols, vals, plan.shape).to_csc()
