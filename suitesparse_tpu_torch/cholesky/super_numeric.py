"""Supernodal numeric factorization + solves in PyTorch (CPU or CUDA).

Counterpart of suitesparse_tpu/cholesky/super_numeric.py.  The host plan
(buckets, static scatter maps) is the reference's, copied; the device side
is plain PyTorch on an explicit ``device``:

  * the whole factor lives in one flat buffer of PRE-PADDED panels, each
    (level, shape-bucket) group contiguous, so every bucket is one slice
    of the buffer (a view);
  * where the reference rebuilt the buffer with ``dynamic_update_slice``
    (which XLA aliases in place), the port writes into that slice in
    place;
  * every scatter goes through the static sorted/unique maps: duplicates
    are folded by a segment sum over sorted ids and the final scatter
    hits each target once, so no atomics run and refactorizations are
    bit-identical on the card.

The small-pattern "unrolled" program (``resolve_program`` picks it for at
most ``wave_threshold`` buckets) runs batched ``torch.linalg`` Cholesky /
triangular solves per bucket, as the reference runs XLA's; larger patterns
run the pass-forward program of pf.py, whose diagonal blocks go through
the hand-written kernel of kernels.py.  program="wave" runs the same
per-bucket arithmetic over uniform waves (wave.wave_numeric).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC
from ..core.status import Status
from ..utils.device import (default_dtype, numpy_dtype, resolve_device,
                            torch_dtype)
from ..utils.programs import (Binding, DeviceProgram, cached_program,
                              pattern_map, program_device)
from ..utils.trace import moved, nbytes, span, spanned
from .supernodal import SuperSymbolic
from .symbolic import Symbolic


@dataclasses.dataclass
class _Bucket:
    sids: np.ndarray        # supernode ids (defines batch order)
    Np: int                 # padded column count
    Mb: int                 # padded below-row count
    base: int               # flat offset of this bucket's contiguous panels
    W: int                  # wave batch size (instruction unit, wave.py/pf.py)
    padeye: np.ndarray      # (B, Np) 1.0 where padded diagonal row
    rowmask: np.ndarray     # (B, Np+Mb) 1.0 for real rows
    colmask: np.ndarray     # (B, Np) 1.0 for real columns
    colidx: np.ndarray      # (B, Np) global column index (n = trash)
    rowidx: np.ndarray      # (B, Mb) global below-row index (n = trash)
    _mk_dest: object = None  # lazy builder for the all-ancestor dest map
    _dest: np.ndarray = None
    # sorted-segment extend-add: gather only the real update entries in
    # destination order and fold duplicates with a sorted segment sum
    seg_src: np.ndarray = None     # indices into flat U, sorted by dest
    seg_ids: np.ndarray = None     # segment id per entry (sorted)
    seg_dst: np.ndarray = None     # unique destinations (K,)
    smaps: tuple = None            # cached solve-phase scatter maps

    @property
    def dest(self) -> np.ndarray:
        """(B, Mb, Mb) flat extend-add targets into ALL ancestor panels
        (trash pad).  Lazy: the pass-forward program (pf.py) never needs
        it."""
        if self._dest is None:
            self._dest = self._mk_dest()
        return self._dest

    def segsum_maps(self, trash: int):
        if self.seg_dst is None:
            self.seg_src, self.seg_ids, self.seg_dst = scatter_add_maps(
                self.dest.reshape(-1), trash)
        return self.seg_src, self.seg_ids, self.seg_dst

    def solve_maps(self, n: int):
        """Static maps making the solve-phase scatters sorted (+unique):
        (c_src, c_dst) reorder the per-column set x[cols] = xc, and
        (r_src, r_ids, r_dst) turn the below-row update x[rows] -= upd into
        a sorted segment sum + sorted/unique scatter (pad rows are dropped
        on the host)."""
        if self.smaps is None:
            cflat = self.colidx.reshape(-1)
            c_src, c_dst = sorted_scatter_maps(
                np.where(cflat == n, -1, cflat))
            r_src, r_ids, r_dst = scatter_add_maps(self.rowidx.reshape(-1), n)
            self.smaps = (c_src, c_dst, r_src, r_ids, r_dst)
        return self.smaps


def _index(a, device) -> torch.Tensor:
    """Host index array -> int64 tensor on ``device`` (torch indexes with
    int64 only)."""
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _seg_lengths(ids: np.ndarray, K: int, device) -> torch.Tensor:
    """Run lengths of the sorted segment ids (K segments, some empty)."""
    return _index(np.bincount(np.asarray(ids, dtype=np.int64).reshape(-1),
                              minlength=K)[:K], device)


@dataclasses.dataclass
class NumericPlan:
    """Static per-pattern plan."""

    ss: SuperSymbolic
    levels: list[list[_Bucket]]
    total: int
    n: int
    meta: tuple             # static shapes: per level, per bucket (Np,Mb,base,B)
    _wave: object = None    # cached WavePlan (wave.py), built on demand
    _pf: object = None      # cached PFPlan (pf.py), built on demand
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def nbuckets(self) -> int:
        return sum(len(lv) for lv in self.levels)

    def wave_plan(self, solve_only: bool = False):
        if self._wave is None or (self._wave.solve_only and not solve_only):
            from .wave import build_wave_plan
            self._wave = build_wave_plan(self, solve_only)
        return self._wave

    def pf_plan(self, common=None):
        if self._pf is None:
            from .pf import build_pf_plan
            self._pf = build_pf_plan(self, common)
        return self._pf

    def resolve_program(self, common=None) -> str:
        """Resolve Common.cholesky.program ("auto") to a concrete program."""
        cm = common or default_common()
        mode = cm.cholesky.program
        if mode == "auto":
            return ("pf" if self.nbuckets > cm.cholesky.wave_threshold
                    else "unrolled")
        return mode

    def use_wave(self, common=None) -> bool:
        return self.resolve_program(common) in ("wave", "pf")

    def arrays_segsum(self, dtype, device):
        """Device operands of the unrolled program's sorted-segment
        extend-add, per level and bucket (cached per dtype and device)."""
        dt, dev = torch_dtype(dtype), torch.device(device)
        key = ("segsum", dt, dev)
        got = self._cache.get(key)
        if got is None:
            got = []
            for lv in self.levels:
                row = []
                for b in lv:
                    src, ids, dst = b.segsum_maps(self.total)
                    row.append(dict(
                        padeye=torch.as_tensor(b.padeye, dtype=dt, device=dev),
                        rowmask=torch.as_tensor(b.rowmask, dtype=dt,
                                                device=dev),
                        colmask=torch.as_tensor(b.colmask, dtype=dt,
                                                device=dev),
                        src=_index(src, dev), dst=_index(dst, dev),
                        lens=_seg_lengths(ids, len(dst), dev)))
                got.append(row)
            self._cache[key] = got
        return got

    def solve_arrays(self, dtype, device):
        dt, dev = torch_dtype(dtype), torch.device(device)
        key = ("solve", dt, dev)
        got = self._cache.get(key)
        if got is None:
            got = []
            for lv in self.levels:
                row = []
                for b in lv:
                    c_src, c_dst, r_src, r_ids, r_dst = b.solve_maps(self.n)
                    row.append(dict(
                        padeye=torch.as_tensor(b.padeye, dtype=dt, device=dev),
                        colidx=_index(b.colidx, dev),
                        rowidx=_index(b.rowidx, dev),
                        c_src=_index(c_src, dev), c_dst=_index(c_dst, dev),
                        r_src=_index(r_src, dev), r_dst=_index(r_dst, dev),
                        r_lens=_seg_lengths(r_ids, len(r_dst), dev)))
                got.append(row)
            self._cache[key] = got
        return got


def _bucket_dest(ss: SuperSymbolic, rows_of, sids, Np, Mb,
                 trash: int) -> np.ndarray:
    """All-ancestor extend-add targets for one bucket: U entry (i, c) of
    supernode s goes to the panel of the supernode owning column r[c]
    (vectorized over rows/columns; no per-column Python loop)."""
    sup = ss.super
    B = len(sids)
    dest = np.full((B, Mb, Mb), trash, dtype=INDEX)
    for b, s in enumerate(np.asarray(sids).tolist()):
        ms, ns = ss.panel_shape(s)
        mb = ms - ns
        if not mb:
            continue
        r = rows_of[s][ns:]
        t_of = ss.col_to_super[r]
        ar = np.arange(mb)
        for t in np.unique(t_of):
            rows_t = rows_of[t]
            j1_t = int(sup[t])
            loc = np.searchsorted(rows_t, r)
            ok = loc < len(rows_t)
            loc_c = np.clip(loc, 0, max(len(rows_t) - 1, 0))
            ok &= rows_t[loc_c] == r
            frow = (int(ss.panel_off[t])
                    + ss.norm_local(t, loc_c) * int(ss.panel_Np[t]))
            csel = np.nonzero(t_of == t)[0]
            d = frow[:, None] + (r[csel] - j1_t)[None, :]
            # column validity: target col r[c] must be a column of t;
            # rows >= that column (lower triangle)
            valid = ok[:, None] & (ar[:, None] >= csel[None, :])
            dest[b][:mb, csel] = np.where(valid, d, trash)
    return dest


@spanned("plan.build_plan")
def build_plan(ss: SuperSymbolic) -> NumericPlan:
    n, total = ss.n, ss.total
    trash = total
    sup = ss.super
    rows_of = [ss.rows_of(s) for s in range(ss.nsuper)]
    levels_out: list[list[_Bucket]] = []
    meta = []
    for level_buckets in ss.level_buckets:
        buckets = []
        lvl_meta = []
        for (Np, Mb, bbase, sids, W) in level_buckets:
            B = len(sids)
            Mp = Np + Mb
            padeye = np.zeros((B, Np))
            rowmask = np.zeros((B, Mp))
            colmask = np.zeros((B, Np))
            colidx = np.full((B, Np), n, dtype=INDEX)
            rowidx = np.full((B, Mb), n, dtype=INDEX)
            for b, s in enumerate(sids.tolist()):
                ms, ns = ss.panel_shape(s)
                mb = ms - ns
                j1 = int(sup[s])
                padeye[b, ns:] = 1.0
                rowmask[b, :ns] = 1.0
                rowmask[b, Np:Np + mb] = 1.0
                colmask[b, :ns] = 1.0
                colidx[b, :ns] = j1 + np.arange(ns)
                if mb:
                    rowidx[b, :mb] = rows_of[s][ns:]
            mk = (lambda sids=sids, Np=Np, Mb=Mb:
                  _bucket_dest(ss, rows_of, sids, Np, Mb, trash))
            buckets.append(_Bucket(sids=sids, Np=Np, Mb=Mb, base=int(bbase),
                                   W=int(W), padeye=padeye, rowmask=rowmask,
                                   colmask=colmask, colidx=colidx,
                                   rowidx=rowidx, _mk_dest=mk))
            lvl_meta.append((Np, Mb, int(bbase), B))
        levels_out.append(buckets)
        meta.append(tuple(lvl_meta))
    return NumericPlan(ss=ss, levels=levels_out, total=total, n=n,
                       meta=tuple(meta))


# ---------------------------------------------------------------------------
# Shared device helpers
# ---------------------------------------------------------------------------

def segment_sum(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Sum of consecutive runs of ``data`` along dim 0: run k has lens[k]
    entries (sorted segment ids, as every map of the plan has).  Each
    segment is reduced in one fixed order without atomics, so the result
    is bit-identical from run to run on the card.  Complex data (which
    segment_reduce does not take) is summed as (real, imaginary) pairs."""
    if data.is_complex():
        return torch.view_as_complex(
            segment_sum(torch.view_as_real(data), lens))
    return torch.segment_reduce(data, "sum", lengths=lens, axis=0,
                                unsafe=True)


def cholesky_or_nan(T: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor; a block that is not positive
    definite comes out all NaN (jnp.linalg.cholesky's contract, which the
    NOT_POSDEF scan relies on), where torch.linalg.cholesky would raise."""
    L, info = torch.linalg.cholesky_ex(T)
    return torch.where((info == 0)[:, None, None], L,
                       torch.full_like(L, float("nan")))


def syrk(B: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """U = B B^T for a batch B (W, m, k), in B's dtype.

    bf16 (Common.cholesky.syrk_bf16): the reference's einsum of bfloat16
    inputs with ``preferred_element_type`` = the factor's dtype, i.e. the
    inputs rounded to bfloat16 and the products summed in B's dtype.  On
    the card in float32 that is one bf16 product with float32 output (the
    tensor cores); elsewhere the rounded values are cast back and
    multiplied in B's dtype, the same function, since the product of two
    bf16 values is exact in float32 and float64.  (A plain bf16 matmul
    would round the update itself to bf16: not the reference's function.)
    """
    if not bf16:
        return B @ B.transpose(1, 2)
    Bs = B.to(torch.bfloat16)
    if B.device.type == "cuda" and B.dtype == torch.float32:
        return torch.bmm(Bs, Bs.transpose(1, 2), out_dtype=torch.float32)
    Bs = Bs.to(B.dtype)
    return Bs @ Bs.transpose(1, 2)


def _panels(Lx: torch.Tensor, base: int, B: int, Mp: int, Np: int):
    """View of B contiguous (Mp, Np) panels of the flat buffer at base."""
    return Lx[base:base + B * Mp * Np].view(B, Mp, Np)


# ---------------------------------------------------------------------------
# Factorization (unrolled program)
# ---------------------------------------------------------------------------

def sorted_scatter_maps(dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Static maps turning an assembly scatter into a sorted+unique one.

    Returns (src, dsort): indices into the value array ordered by
    destination, and the matching sorted destinations.  Entries with
    dst < 0 are dropped.  Assembly destinations are distinct panel slots,
    so a scatter through these maps hits each target exactly once.
    """
    src = np.nonzero(np.asarray(dst) >= 0)[0]
    d = np.asarray(dst)[src]
    order = np.argsort(d, kind="stable")
    dsort = d[order]
    # the device scatter relies on unique destinations; a duplicate
    # (e.g. duplicate entries in the input matrix feeding the assembly
    # map) would silently drop a value -- fail loudly here
    assert np.all(np.diff(dsort) > 0), \
        "sorted_scatter_maps: duplicate destinations (non-unique scatter)"
    return src[order].astype(INDEX), dsort.astype(INDEX)


def scatter_add_maps(dst: np.ndarray,
                     trash: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static maps turning a scatter-ADD with duplicate destinations into a
    static gather + sorted segment sum + sorted/unique scatter.

    Returns (src, ids, uniq): value indices ordered by destination, the
    segment id of each, and the unique destinations.  Entries equal to
    `trash` are dropped.
    """
    flat = np.asarray(dst).reshape(-1)
    real = np.nonzero(flat != trash)[0]
    d = flat[real]
    order = np.argsort(d, kind="stable")
    src = real[order].astype(INDEX)
    uniq, ids = np.unique(d[order], return_inverse=True)
    assert uniq.size == 0 or np.all(np.diff(uniq) > 0)
    return src, ids.astype(INDEX), uniq.astype(INDEX)


def _a_sorted_maps(ss: SuperSymbolic):
    maps = getattr(ss, "_a_sorted", None)
    if maps is None:
        maps = sorted_scatter_maps(ss.a_scatter_dst)
        ss._a_sorted = maps
    return maps


def _device_amaps(cache: dict, ss: SuperSymbolic, dev) -> tuple:
    """The sorted assembly maps as index tensors on ``dev``, cached in a
    plan's ``cache``."""
    key = ("amaps", dev)
    got = cache.get(key)
    if got is None:
        a_src, a_dst = _a_sorted_maps(ss)
        got = cache[key] = (_index(a_src, dev), _index(a_dst, dev))
    return got


def assemble(vals: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
             size: int) -> torch.Tensor:
    """Zero factor buffer of ``size`` with tril(PAP') set into its panel
    slots (a sorted, unique set)."""
    Lx = vals.new_zeros(size)
    Lx[a_dst] = vals[a_src]
    return Lx


def _level_step_segsum(Lx, bucket_arrays, bucket_meta, syrk_bf16=False):
    """One level: each bucket's panels factored in one batch (POTRF, TRSM,
    SYRK), written back in place, then the sorted-segment extend-add: one
    static gather of the real update entries, a sorted segment sum that
    folds duplicates, and a scatter onto unique targets.

    syrk_bf16: the SYRK update from bfloat16 inputs summed in the factor's
    dtype (``syrk``); the POTRF/TRSM panels keep the factor's dtype."""
    for ops, (Np, Mb, base, B) in zip(bucket_arrays, bucket_meta):
        Mp = Np + Mb
        P = _panels(Lx, base, B, Mp, Np)
        T = P[:, :Np, :]
        Tfull = T + torch.tril(T, -1).transpose(1, 2)
        Tfull = Tfull + torch.diag_embed(ops["padeye"])
        C = cholesky_or_nan(Tfull)
        if Mb:
            # Bm = B C^-T, i.e. the X with X C^T = B
            Bm = torch.linalg.solve_triangular(
                C.transpose(1, 2), P[:, Np:, :], upper=True, left=False)
            U = syrk(Bm, syrk_bf16)
            newP = torch.cat([C, Bm], dim=1)
        else:
            newP = C
        P.copy_(newP * ops["rowmask"][:, :, None] * ops["colmask"][:, None, :])
        dst = ops["dst"]
        if Mb and dst.shape[0]:
            # targets live in LATER (ancestor) buckets only, so updating
            # after this bucket's write is hazard-free
            seg = segment_sum(U.reshape(-1)[ops["src"]], ops["lens"])
            Lx[dst] -= seg
    return Lx


def _numeric_program(vals, a_src, a_dst, level_arrays, meta, total,
                     syrk_bf16=False):
    """The full numeric factorization: sorted A-assembly into the zero
    panel buffer, then the level schedule.  Reused verbatim across
    refactorizations."""
    Lx = assemble(vals, a_src, a_dst, total + 1)
    for li in range(len(meta)):
        Lx = _level_step_segsum(Lx, level_arrays[li], meta[li], syrk_bf16)
    return Lx


def unrolled_program(plan: NumericPlan, dtype, syrk_bf16=False,
                     device=None) -> DeviceProgram:
    """``_numeric_program`` as a device program, cached on the plan per
    (dtype, syrk_bf16, device): the reference's jitted unrolled program
    (suitesparse_tpu/cholesky/super_numeric.py:413-421)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def make():
        a_src, a_dst = _device_amaps(plan._cache, plan.ss, dev)
        arrays = plan.arrays_segsum(dt, dev)
        return lambda vals: _numeric_program(vals, a_src, a_dst, arrays,
                                             plan.meta, plan.total,
                                             syrk_bf16)

    return cached_program(plan._cache, ("unrolled", dt, bool(syrk_bf16),
                                        dev), make, dev)


def factor_program(plan: NumericPlan, common: Common, dtype,
                   device) -> DeviceProgram:
    """The device program that factorize_super runs for ``plan`` under
    ``common`` (Common.cholesky.program, syrk_bf16 and trsm_inv)."""
    opts = common.cholesky
    prog = plan.resolve_program(common)
    if prog == "pf":
        from .pf import pf_program
        return pf_program(plan.pf_plan(common), dtype, opts.syrk_bf16,
                          opts.trsm_inv, device)
    if prog == "wave":
        from .wave import wave_program
        return wave_program(plan.wave_plan(), dtype, opts.syrk_bf16, device)
    return unrolled_program(plan, dtype, opts.syrk_bf16, device)


@dataclasses.dataclass
class SuperFactor:
    """Numeric supernodal factor: flat panel buffer + plan (PAP' = LL')."""

    plan: NumericPlan
    Lx: torch.Tensor            # padded panels (+ trash / update regions)
    perm: np.ndarray
    minor: int
    dtype: object               # numpy float dtype of Lx
    _dinv: object = None        # per-factor inverted diagonal blocks

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def ok(self) -> bool:
        return self.minor == self.n

    def to_simplicial(self):
        """cholmod_change_factor(super -> simplicial LL') equivalent: the
        panels copied to the host as a simplicial Factor."""
        from .simplicial import Factor
        ss = self.plan.ss
        n = ss.n
        Lx_h = self.Lx.detach().cpu().numpy()
        cols_i: list[np.ndarray] = []
        cols_x: list[np.ndarray] = []
        Lp = np.zeros(n + 1, dtype=INDEX)
        for s in range(ss.nsuper):
            ms, ns = ss.panel_shape(s)
            mb = ms - ns
            Np = int(ss.panel_Np[s])
            Mp = int(ss.panel_Mp[s])
            o = int(ss.panel_off[s])
            Pn = Lx_h[o:o + Mp * Np].reshape(Mp, Np)
            rows = ss.rows_of(s)
            for c in range(ns):
                j = int(ss.super[s]) + c
                ri = rows[c:]
                vx = np.concatenate([Pn[c:ns, c], Pn[Np:Np + mb, c]])
                cols_i.append(ri)
                cols_x.append(vx)
                Lp[j + 1] = len(ri)
        np.cumsum(Lp, out=Lp)
        Li = np.concatenate(cols_i) if cols_i else np.empty(0, dtype=INDEX)
        Lxs = np.concatenate(cols_x) if cols_x else np.empty(0)
        return Factor(n=n, perm=self.perm, Lp=Lp, Li=Li.astype(INDEX),
                      Lx=Lxs, D=None, is_ll=True, minor=self.minor,
                      symbolic=None)


def _assemble_values(A: SparseCSC, sym: Symbolic, ss: SuperSymbolic,
                     dtype, beta: float = 0.0) -> np.ndarray:
    """Values of tril(PAP') in the canonical order matching a_scatter_dst."""
    from ..core.sparse import sym_upper_view
    U = sym_upper_view(A)
    P = U.symperm(sym.perm, values=True).sort_indices()
    PL = P.transpose(values=True)
    PL.sort_indices()
    vals = PL.data.astype(dtype)
    if beta:
        col = np.repeat(np.arange(ss.n, dtype=INDEX), np.diff(PL.indptr))
        vals = vals + beta * (PL.indices == col)
    return vals


def _value_map(plan: NumericPlan, A: SparseCSC, sym: Symbolic) -> np.ndarray:
    """Positions in ``A.data`` of the values of tril(PAP') in the order of
    ``_assemble_values``, which selects and reorders A's entries and never
    adds two: ``A.data[vmap].astype(dtype)`` is its result bit for bit.
    ``sym`` is the analysis the plan was built from.

    Made once per pattern (span ``plan.value_map``) by running that chain
    on ``arange(nnz)``, and kept in ``plan._cache`` as a ``PatternMap``
    (utils/programs), reused while A has the pattern it was made from and
    rebuilt for another pattern or layout."""
    def build():
        pos = SparseCSC(A.indptr, A.indices, np.arange(A.nnz, dtype=INDEX),
                        A.shape, stype=A.stype, sorted=A.sorted)
        itype = np.int32 if A.nnz < 2**31 else np.int64
        return _assemble_values(pos, sym, plan.ss, itype), None

    return pattern_map(plan._cache, "value_map", A, build,
                       "plan.value_map").vmap


def _first_nan_super(ss: SuperSymbolic, Lx: torch.Tensor) -> int:
    """First column of the first supernode whose panel holds a NaN
    (the failed pivot's supernode), or n."""
    h = Lx.detach().cpu().numpy()
    for s in range(ss.nsuper):
        o = int(ss.panel_off[s])
        sz = int(ss.panel_Mp[s]) * int(ss.panel_Np[s])
        if np.isnan(h[o:o + sz]).any():
            return int(ss.super[s])
    return ss.n


@spanned("super.factorize")
def factorize_super(A: SparseCSC, sym: Symbolic, ss: SuperSymbolic,
                    plan: Optional[NumericPlan] = None,
                    common: Optional[Common] = None,
                    dtype=None, device=None) -> SuperFactor:
    """Numeric supernodal LL' of PAP' (values change, pattern fixed).

    device: "cuda" by default (raises when no card is present) or "cpu".
    dtype: float64 on the CPU and float32 on the card unless given.

    Spans (utils/trace): ``super.factorize`` around the call, and inside it
    ``.assemble`` (the values of tril(PAP') gathered on the host through
    ``_value_map``, whose build on a pattern's first call is the span
    ``plan.value_map`` inside it), ``.upload``,
    ``.prepare`` (first call: the program's warm-up and capture),
    ``.program`` (copy-in, replay, clone of the result), ``.wait`` (for the
    device) and ``.nan_scan``.  cm.info: ``factor_time`` is the program's
    call and the wait, ``factor_assemble_time`` the host assembly."""
    cm = common or default_common()
    cm.checkpoint("super_numeric")
    if np.iscomplexobj(A.data) or (dtype is not None
                                   and not isinstance(dtype, torch.dtype)
                                   and np.issubdtype(np.dtype(dtype),
                                                     np.complexfloating)):
        raise TypeError(
            "supernodal programs are real-only (no conjugate in the "
            "symmetrize/SYRK steps); use the simplicial path for complex "
            "matrices")
    dev = resolve_device(device)
    dtype = numpy_dtype(default_dtype(dev) if dtype is None else dtype)
    plan = plan or build_plan(ss)
    prog = factor_program(plan, cm, dtype, dev)
    with span("super.factorize.assemble") as assembly:
        host = np.take(A.data, _value_map(plan, A, sym)).astype(dtype,
                                                                copy=False)
    with span("super.factorize.upload"):
        vals = torch.as_tensor(host, device=dev)
        moved("h2d", host.nbytes)
    if not prog.prepared:
        # the warm-up and the capture stand apart from the refactorization,
        # as a first jit call's compile time does
        with span("super.factorize.prepare"):
            prog.prepare(vals)
        cm.info.update({"factor_warmup_time": prog.warmup_s,
                        "factor_capture_time": prog.capture_s,
                        "factor_graph_nodes": prog.nodes})
    with span("super.factorize.program") as run:
        Lx = prog(vals)
    with span("super.factorize.wait") as wait:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with span("super.factorize.nan_scan"):
        failed = bool(torch.isnan(Lx).any())

    minor = plan.n
    if failed:
        cm.status = Status.NOT_POSDEF
        minor = _first_nan_super(ss, Lx)
    else:
        cm.status = Status.OK
    cm.info.update({"factor_time": run.seconds + wait.seconds,
                    "factor_assemble_time": assembly.seconds,
                    "minor": minor})
    return SuperFactor(plan=plan, Lx=Lx, perm=sym.perm, minor=minor,
                       dtype=dtype)


def factor_from_numpy(plan: NumericPlan, Lx: np.ndarray, perm: np.ndarray,
                      minor: Optional[int] = None,
                      device=None) -> SuperFactor:
    """Adopt a flat panel buffer computed elsewhere (e.g. by the JAX
    package, whose plans are identical by construction) as a SuperFactor
    on ``device``.  ``minor`` defaults to n (a complete factor)."""
    dev = resolve_device(device)
    Lx = np.asarray(Lx)
    return SuperFactor(plan=plan, Lx=torch.tensor(Lx, device=dev),
                       perm=np.asarray(perm),
                       minor=plan.n if minor is None else int(minor),
                       dtype=numpy_dtype(Lx.dtype))


# ---------------------------------------------------------------------------
# Solves (cholmod_super_lsolve / super_ltsolve,
#         reference Supernodal/t_cholmod_super_solve.c:89-195)
# ---------------------------------------------------------------------------

def _set_cols(x, xc, c_src, c_dst):
    """x[cols] = xc through sorted+unique static maps."""
    k = xc.shape[-1]
    x[c_dst] = xc.reshape(-1, k)[c_src]


def _sub_rows(x, upd, r_src, r_lens, r_dst):
    """x[rows] -= upd with duplicate rows folded by a sorted segment sum
    and a scatter onto unique rows."""
    k = upd.shape[-1]
    x[r_dst] -= segment_sum(upd.reshape(-1, k)[r_src], r_lens)


def _lsolve_impl(Lx, x, level_arrays, meta):
    for li in range(len(meta)):
        for ops, (Np, Mb, base, B) in zip(level_arrays[li], meta[li]):
            P = _panels(Lx, base, B, Np + Mb, Np)
            C = P[:, :Np, :] + torch.diag_embed(ops["padeye"])
            xc = torch.linalg.solve_triangular(C, x[ops["colidx"]],
                                               upper=False)
            _set_cols(x, xc, ops["c_src"], ops["c_dst"])
            if Mb and ops["r_src"].shape[0]:
                _sub_rows(x, P[:, Np:, :] @ xc, ops["r_src"], ops["r_lens"],
                          ops["r_dst"])
    return x


def _ltsolve_impl(Lx, x, level_arrays, meta):
    for li in range(len(meta) - 1, -1, -1):
        for ops, (Np, Mb, base, B) in zip(level_arrays[li], meta[li]):
            P = _panels(Lx, base, B, Np + Mb, Np)
            C = P[:, :Np, :] + torch.diag_embed(ops["padeye"])
            xc = x[ops["colidx"]]
            if Mb:
                xc = xc - P[:, Np:, :].transpose(1, 2) @ x[ops["rowidx"]]
            xc = torch.linalg.solve_triangular(C.transpose(1, 2), xc,
                                               upper=True)
            _set_cols(x, xc, ops["c_src"], ops["c_dst"])
    return x


_SOLVE_SYSTEMS = {"A": "A", "LLt": "LLt", "LDLt": "LLt", "L": "L",
                  "Lt": "Lt"}


def _solve_wave_plan(plan: NumericPlan, common: Optional[Common]):
    """The wave plan the solves walk.  pf factors reuse the wave solve;
    only the solve maps are needed, so a solve-only plan (or a full one
    already built) serves every later solve too.  (The reference asks for
    the full plan from the second solve on, which rebuilds the factor's
    extend-add maps: seconds at lap3d_44 for maps the solve never reads.)"""
    return plan.wave_plan(solve_only=plan.resolve_program(common) == "pf")


def _solve_body(plan: NumericPlan, system: str, wave: bool,
                common: Optional[Common], Lx, Dv, perm, invperm):
    """The solve of ``system`` over the panel buffer ``Lx`` (its first
    plan.total entries), the inverted diagonal blocks ``Dv`` (wave route)
    and the permutation ``perm``/``invperm`` (device index tensors): a
    function b (n, k) -> x (n, k)."""
    n = plan.n
    dt, dev = Lx.dtype, Lx.device
    if wave:
        from .wave import _dinv_layout, wave_lsolve, wave_ltsolve
        wp = _solve_wave_plan(plan, common)
        wp.solve_arrays(dt, dev)
        _dinv_layout(wp)
        xrows = n + wp.xpad

        def lsolve(x):
            return wave_lsolve(wp, Lx, x, Dv)

        def ltsolve(x):
            return wave_ltsolve(wp, Lx, x, Dv)
    else:
        xrows = n + 1
        la = plan.solve_arrays(dt, dev)

        def lsolve(x):
            return _lsolve_impl(Lx, x, la, plan.meta)

        def ltsolve(x):
            return _ltsolve_impl(Lx, x, la, plan.meta)

    def body(b):
        x = b.new_zeros((xrows, b.shape[1]))
        x[:n] = b[perm] if system == "A" else b
        if system != "Lt":
            x = lsolve(x)
        if system != "L":
            x = ltsolve(x)
        return x[invperm] if system == "A" else x[:n]
    return body


@dataclasses.dataclass(eq=False)
class SolveFactor:
    """The factor that a plan's solve programs read, one per route, dtype
    and device, cached on the plan: the panels (the flat buffer's first
    ``plan.total`` entries, where every panel lies), the inverted diagonal
    blocks (wave route; ``dinv`` builds them from ``Lx``) and the
    permutation.  ``bind_solve_factor`` copies a factor in; ``bound``
    says whose values these are."""

    Lx: torch.Tensor
    Dv: Optional[torch.Tensor]
    perm: torch.Tensor
    invperm: torch.Tensor
    dinv: Optional[DeviceProgram]
    bound: Binding
    perm_host: Optional[np.ndarray] = None


def _solve_factor(plan: NumericPlan, wave: bool, dt: torch.dtype,
                  dev: torch.device,
                  common: Optional[Common]) -> SolveFactor:
    key = ("solve_factor", wave, dt, dev)
    got = plan._cache.get(key)
    if got is None:
        Lx = torch.zeros(plan.total, dtype=dt, device=dev)
        Dv = dinv = None
        if wave:
            from .wave import _dinv_layout, dinv_program
            wp = _solve_wave_plan(plan, common)
            Dv = torch.zeros(max(_dinv_layout(wp)[1], 1), dtype=dt,
                             device=dev)
            dinv = dinv_program(wp, Lx)
        idx = torch.zeros(plan.n, dtype=torch.int64, device=dev)
        got = plan._cache[key] = SolveFactor(
            Lx=Lx, Dv=Dv, perm=idx, invperm=idx.clone(), dinv=dinv,
            bound=Binding((Lx,) if Dv is None else (Lx, Dv)))
    return got


def bind_solve_factor(f: SuperFactor,
                      common: Optional[Common] = None) -> SolveFactor:
    """Make ``f`` the factor that its plan's solve programs read (for its
    route, dtype and device) and return the plan's ``SolveFactor``.  The
    panels, the inverted diagonal blocks (built once per factor, kept on
    it) and the permutation are copied in only when another factor, or
    other values, are there: repeated solves on one factor copy nothing."""
    plan = f.plan
    wave = plan.use_wave(common)
    dev = f.Lx.device
    R = _solve_factor(plan, wave, f.Lx.dtype, dev, common)

    def sources():
        # the permutation is compared on the host and copied only if new
        if R.perm_host is None or not np.array_equal(R.perm_host, f.perm):
            R.perm.copy_(_index(f.perm, dev))
            R.invperm.copy_(_index(np.argsort(f.perm), dev))
            R.perm_host = np.array(f.perm)
            moved("h2d", 2 * nbytes(R.perm))
            moved("d2d", 2 * nbytes(R.perm))
        yield f.Lx[:plan.total]
        if wave:
            if f._dinv is None:
                f._dinv = R.dinv()      # from the panels just copied in
            yield f._dinv

    R.bound.load("super.solve.bind", f, (f.Lx,), sources)
    return R


def solve_program(plan: NumericPlan, system: str, k: int, dtype, device,
                  common: Optional[Common] = None) -> DeviceProgram:
    """The device program of one solve system ("A", "LLt", "L" or "Lt")
    for k right-hand sides, one per (plan, system, k, dtype, device) and
    cached on the plan, as the reference compiles its lsolve/ltsolve
    programs once per pattern (suitesparse_tpu/cholesky/
    super_numeric.py:554-575 and wave.py:517-559): b (n, k) -> x (n, k).
    It reads the factor bound by ``bind_solve_factor`` (its panels come in
    as data, as the reference's ``Lx`` argument).  "A" applies P and P'
    inside the program.  pf and wave factors solve over the waves with the
    factor's inverted diagonal blocks; unrolled factors over the levels."""
    dev = program_device(resolve_device(device))
    dt = torch_dtype(dtype)
    wave = plan.use_wave(common)

    def make():
        R = _solve_factor(plan, wave, dt, dev, common)
        return _solve_body(plan, system, wave, common, R.Lx, R.Dv, R.perm,
                           R.invperm)

    return cached_program(plan._cache, ("solve_" + system, wave, dt, int(k),
                                        dev), make, dev)


@spanned("super.solve")
def solve_super(f: SuperFactor, b: np.ndarray, system: str = "A",
                common: Optional[Common] = None) -> np.ndarray:
    """cholmod_solve on a supernodal factor. Systems: A, LLt, L, Lt, P, Pt.

    Runs on the factor's device through the plan's ``solve_program``
    after ``bind_solve_factor`` (P and Pt on the host); b and the result
    are host arrays.

    Spans (utils/trace): ``super.solve`` around the call, and inside it
    ``.bind`` (where ``bind_solve_factor`` copies a factor in), ``.upload``
    (b to the device in the factor's dtype), ``.program`` (copy-in,
    replay, clone), ``.wait`` (for the device) and ``.download``."""
    n = f.plan.n
    b = np.asarray(b)
    one_d = b.ndim == 1
    bk = b.reshape(n, 1) if one_d else b
    perm = f.perm
    if system == "P":
        out = bk[perm]
    elif system == "Pt":
        out = np.empty_like(bk)
        out[perm] = bk
    elif system in _SOLVE_SYSTEMS:
        bind_solve_factor(f, common)
        dev = f.Lx.device
        prog = solve_program(f.plan, _SOLVE_SYSTEMS[system], bk.shape[1],
                             f.Lx.dtype, dev, common)
        with span("super.solve.upload"):
            bt = torch.as_tensor(bk, device=dev).to(f.Lx.dtype)
            moved("h2d", bk.nbytes)
        with span("super.solve.program"):
            x = prog(bt)
        with span("super.solve.wait"):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        with span("super.solve.download"):
            out = x.cpu().numpy()
            moved("d2h", out.nbytes)
    else:
        raise ValueError(f"unknown system {system!r}")
    return out.reshape(-1) if one_d else out
