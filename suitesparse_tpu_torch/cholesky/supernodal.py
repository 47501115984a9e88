"""Supernodal symbolic analysis: supernode partition, packed panel layout,
level schedule, and static gather/scatter maps for the TPU numeric phase.

Reference behavior (CHOLMOD/Supernodal/cholmod_super_symbolic.c):
  * fundamental supernodes (:415-434): column j joins column j-1's
    supernode iff parent[j-1] == j, colcount[j-1] == colcount[j] + 1, and
    j has exactly one child in the etree;
  * relaxed amalgamation (:475-560): merge a child supernode into its
    parent if small (ns <= nrelax0) or if the fraction of explicit zeros z
    stays under staged thresholds (ns<=nrelax1 && z<zrelax0) ||
    (ns<=nrelax2 && z<zrelax1) || z<zrelax2.  Reference defaults
    nrelax={4,16,48}, zrelax={0.8,0.1,0.05}; our Common defaults are
    retuned wider for the 128x128 MXU (SURVEY.md §2b item 4).

TPU-first design (NOT in the reference): the factor is a single flat
buffer of dense row-major panels; every irregular access (A scatter,
extend-add between supernodes) is precomputed here as a static index map so
the numeric phase is a fixed sequence of dense kernels + scatter-adds that
XLA can compile once per level shape (SURVEY.md §7.4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.common import Common, default_common
from ..core.sparse import INDEX, SparseCSC
from ..utils.trace import spanned
from .symbolic import Symbolic, analyze, _force_upper


def _pad_dim(x: int, grain: int = 8, max_pow2: int = 128) -> int:
    """Round a panel dimension up to a bucket size: multiples of `grain`
    below 128, then multiples of 128 (MXU tile) above."""
    if x <= grain:
        return grain
    if x <= max_pow2:
        # next power of two-ish: multiples of grain, snapped to powers of 2
        p = grain
        while p < x:
            p *= 2
        return p
    return ((x + max_pow2 - 1) // max_pow2) * max_pow2


def _pad_dim_coarse(x: int) -> int:
    """Coarse shape ladder {8, 32, 128, k*256}: far fewer distinct panel
    shape classes, so the wave program (wave.py) compiles in O(few)
    branches.  The extra padding costs flops/storage the MXU shrugs off —
    the compile-time and dispatch savings dominate (NOTES_ROUND1.md
    ablation: slicing/dispatch floor >> SYRK flops at these sizes)."""
    for v in (8, 32, 128):
        if x <= v:
            return v
    return ((x + 255) // 256) * 256


@dataclasses.dataclass
class SuperSymbolic:
    """Supernodal symbolic factor + all static maps for the numeric phase.

    Panel layout (the TPU-critical choice): every supernode panel is stored
    PRE-PADDED to its shape bucket (Mp = padded rows, Np = padded cols) in
    *normalized* form — rows 0..Np-1 hold the (ns-row) diagonal block, rows
    Np..Mp-1 hold the below-diagonal block — and all panels of one (level,
    bucket) group are CONTIGUOUS.  The numeric phase then reads/writes each
    bucket with one lax.dynamic_slice instead of an arbitrary-index gather
    (measured 50x cheaper on TPU; only the extend-add remains a scatter).
    """

    n: int
    nsuper: int
    super: np.ndarray          # (nsuper+1,) column boundaries
    col_to_super: np.ndarray   # (n,)
    sn_rowptr: np.ndarray      # (nsuper+1,) into sn_rows
    sn_rows: np.ndarray        # concatenated sorted row lists (incl. diag cols)
    panel_off: np.ndarray      # (nsuper,) base offset of the padded panel
    panel_Np: np.ndarray       # (nsuper,) padded column stride
    panel_Mp: np.ndarray       # (nsuper,) padded row count
    total: int                 # total padded panel storage (plus 1 trash slot)
    sn_parent: np.ndarray      # supernodal etree
    levels: list[np.ndarray]   # topo schedule: levels[0] = leaves ... root last
    level_buckets: list        # per level: list of (Np, Mb, base, sids, W)
    lnz_dense: int

    # static maps for numeric
    a_scatter_dst: np.ndarray  # flat positions in Lx for tril(PAP') nonzeros
    a_scatter_src: np.ndarray  # corresponding indices into P.data
    wave_w: Optional[dict] = None  # (Np, Mb) -> wave batch size (wave.py)
    layout_opts: tuple = ("coarse", 0.0)   # (ladder, bucket_merge) used —
    # stored so serialize can re-derive the identical layout on load

    def panel_shape(self, s: int) -> tuple[int, int]:
        ms = int(self.sn_rowptr[s + 1] - self.sn_rowptr[s])
        ns = int(self.super[s + 1] - self.super[s])
        return ms, ns

    def rows_of(self, s: int) -> np.ndarray:
        return self.sn_rows[self.sn_rowptr[s]:self.sn_rowptr[s + 1]]

    def norm_local(self, s: int, local: np.ndarray) -> np.ndarray:
        """Map local row index (0..ms) to the normalized padded row."""
        ns = int(self.super[s + 1] - self.super[s])
        Np = int(self.panel_Np[s])
        local = np.asarray(local)
        return np.where(local < ns, local, Np + (local - ns))

    def flat_pos(self, s: int, local_rows: np.ndarray,
                 rel_cols: np.ndarray) -> np.ndarray:
        """Flat buffer position of panel entries (local row, col - j1)."""
        return (int(self.panel_off[s])
                + self.norm_local(s, local_rows) * int(self.panel_Np[s])
                + np.asarray(rel_cols))


def _pick_wave(Np: int, Mb: int, bs: list[int]) -> int:
    """Wave size for a (Np, Mb) shape class given its bucket sizes.

    A wave is the unit batch of the scanned numeric program (wave.py): big
    buckets split into several waves, small buckets pad up to one wave.
    Sizing: the mean bucket size (weighted toward where the work is),
    rounded up to a power of two, clamped so one wave's panel slice stays
    comfortably in VMEM-scale working memory."""
    w = 1
    target = float(np.mean(bs))
    while w < target:
        w *= 4          # pow4 ladder: fewer distinct (W, shape) kernels
    panel = (Np + Mb) * Np
    while w > 1 and w * panel * 4 > (64 << 20):
        w //= 4
    return max(w, 1)


def _pick_wave_bucket(Np: int, Mb: int, B: int,
                      mem_floats: int = 24 << 20) -> int:
    """Per-bucket wave size: the WHOLE bucket in one instruction when the
    panel slice fits the working-memory budget, else the largest power-of-2
    split.  Round-2 postmortem (VERDICT.md weak #6): sizing waves off the
    *mean* bucket size serialized data-independent panels of one level into
    many small scan steps; one level-sized step keeps the MXU batch large."""
    w = 1
    while w < B:
        w *= 2
    panel = max((Np + Mb) * Np, 1)
    while w > 1 and w * panel > mem_floats:
        w //= 2
    return max(w, 1)


def _merge_level_buckets(groups: dict, budget_frac: float) -> dict:
    """Greedily merge a level's shape buckets (padding both dims up to the
    cluster max) while the padded-volume increase stays under
    budget_frac x the level's original padded volume.

    TPU rationale: every (bucket shape x parent shape) pair is a separate
    compiled instruction in the numeric program, and per-instruction
    dispatch is the scarce resource (tools/microbench_dispatch.py); padded
    panel storage and flops are cheap by comparison.  No reference analog —
    the reference's BLAS calls take any shape for free."""
    if budget_frac <= 0 or len(groups) <= 1:
        return groups

    def vol(np_, mb, count):
        return count * ((np_ + mb) * np_ + mb * mb)

    items = [[np_, mb, list(sids)] for (np_, mb), sids in groups.items()]
    orig = sum(vol(np_, mb, len(s)) for np_, mb, s in items)
    budget = budget_frac * orig
    while len(items) > 1 and budget > 0:
        best = None
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                ni, mi, si = items[i]
                nj, mj, sj = items[j]
                nm, mm = max(ni, nj), max(mi, mj)
                delta = (vol(nm, mm, len(si)) - vol(ni, mi, len(si))
                         + vol(nm, mm, len(sj)) - vol(nj, mj, len(sj)))
                if best is None or delta < best[0]:
                    best = (delta, i, j, nm, mm)
        delta, i, j, nm, mm = best
        if delta > budget:
            break
        budget -= delta
        items[i] = [nm, mm, items[i][2] + items[j][2]]
        del items[j]
    out: dict = {}
    for np_, mb, sids in items:
        out.setdefault((np_, mb), []).extend(sids)
    return out


def _assign_layout(levels, shapes, ladder: str = "coarse",
                   bucket_merge: float = 0.0):
    """Bucket supernodes per level by padded shape and assign contiguous
    padded panel offsets in schedule order.

    shapes: list of (ms, ns) per supernode.  Returns (panel_off, panel_Np,
    panel_Mp, total, level_buckets, wave_w).  Each bucket's panel block is
    rounded up to a whole number of waves (wave_w[(Np, Mb)] panels) so the
    scanned wave program can slice uniform chunks; the pad tail is dead
    zero storage the unrolled program simply never touches.
    """
    pad = _pad_dim_coarse if ladder == "coarse" else _pad_dim
    nsuper = len(shapes)
    panel_off = np.zeros(nsuper, dtype=INDEX)
    panel_Np = np.zeros(nsuper, dtype=INDEX)
    panel_Mp = np.zeros(nsuper, dtype=INDEX)
    # pass 1: group per level, collect bucket sizes per shape class
    per_level_groups = []
    class_bs: dict[tuple[int, int], list[int]] = {}
    for level in levels:
        groups: dict[tuple[int, int], list[int]] = {}
        for s in np.asarray(level).tolist():
            ms, ns = shapes[s]
            mb = ms - ns
            key = (pad(ns), pad(mb) if mb else 0)
            groups.setdefault(key, []).append(s)
        groups = _merge_level_buckets(groups, bucket_merge)
        per_level_groups.append(groups)
        for key, sids in groups.items():
            class_bs.setdefault(key, []).append(len(sids))
    # per-class W kept for consumers that need one W per shape (dist.py);
    # the layout itself reserves per-BUCKET waves (pass 2)
    wave_w = {(Np, Mb): max(_pick_wave_bucket(Np, Mb, B) for B in bs)
              for (Np, Mb), bs in class_bs.items()}
    # pass 2: assign offsets, reserving pad space to a whole wave count
    level_buckets = []
    base = 0
    for groups in per_level_groups:
        buckets = []
        for (Np, Mb), sids in sorted(groups.items()):
            bbase = base
            for s in sids:
                panel_off[s] = base
                panel_Np[s] = Np
                panel_Mp[s] = Np + Mb
                base += (Np + Mb) * Np
            W = _pick_wave_bucket(Np, Mb, len(sids))
            nwave = -(-len(sids) // W)
            base = bbase + nwave * W * (Np + Mb) * Np
            buckets.append((Np, Mb, bbase, np.array(sids, dtype=INDEX), W))
        level_buckets.append(buckets)
    return panel_off, panel_Np, panel_Mp, int(base), level_buckets, wave_w


def _amalgamate(n: int, nsuper: int, super_: np.ndarray, parent: np.ndarray,
                cc: np.ndarray, nrelax, zrelax) -> np.ndarray:
    """Relaxed supernode amalgamation (cholmod_super_symbolic.c:475-560):
    merge child supernode into its parent while the explicit-zero fraction
    stays under the staged thresholds.  Native C++ when available (the
    repeated union-find passes were ~5 s of Python at n=262k); the Python
    fallback implements identical semantics."""
    nrelax0, nrelax1, nrelax2 = nrelax
    zrelax0, zrelax1, zrelax2 = zrelax
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "sstpu_amalgamate"):
        starts = np.empty(nsuper, dtype=np.int64)
        cnt = lib.sstpu_amalgamate(
            n, nsuper, np.ascontiguousarray(super_, dtype=np.int64),
            np.ascontiguousarray(parent, dtype=np.int64),
            np.ascontiguousarray(cc, dtype=np.int64),
            int(nrelax0), int(nrelax1), int(nrelax2),
            float(zrelax0), float(zrelax1), float(zrelax2), starts)
        return np.concatenate([starts[:cnt], [n]]).astype(INDEX)

    super_ = np.asarray(super_, dtype=INDEX).copy()
    merge_parent = np.arange(nsuper, dtype=INDEX)  # union-find
    snsize = np.diff(super_).astype(np.int64)
    zeros = np.zeros(nsuper, dtype=np.float64)  # explicit zeros inside s
    first_cc = cc[super_[:-1]]          # rows in the first column's pattern

    def find(s):
        while merge_parent[s] != s:
            merge_parent[s] = merge_parent[merge_parent[s]]
            s = merge_parent[s]
        return s

    col_sn = np.repeat(np.arange(nsuper, dtype=INDEX), snsize)
    changed = True
    while changed:
        changed = False
        for s in range(nsuper - 1, -1, -1):
            rs = find(s)
            last = int(super_[rs] + snsize[rs] - 1)
            par_col = int(parent[last])
            if par_col == -1:
                continue
            rp = find(int(col_sn[par_col]))
            if rp == rs:
                continue
            # only merge child into parent when columns are contiguous
            if int(super_[rs] + snsize[rs]) != int(super_[rp]):
                continue
            ns0, ns1 = int(snsize[rs]), int(snsize[rp])
            ns = ns0 + ns1
            # explicit zeros created by the merge (reference formula):
            # each of the child's ns0 columns grows to the merged panel
            # height; lnz0/lnz1 = panel heights of child/parent
            lnz0 = int(first_cc[rs])
            lnz1 = int(first_cc[rp])
            newzeros = ns0 * (lnz1 + ns0 - lnz0)
            totzeros = zeros[rs] + zeros[rp] + newzeros
            merged_rows = lnz1 + ns0
            totsize = ns * (ns + 1) / 2.0 + ns * (merged_rows - ns)
            z = totzeros / max(totsize, 1.0)
            ok = (ns <= nrelax0 or newzeros == 0
                  or (ns <= nrelax1 and z < zrelax0)
                  or (ns <= nrelax2 and z < zrelax1)
                  or (z < zrelax2))
            if ok:
                merge_parent[rs] = rp
                super_[rp] = super_[rs]          # parent absorbs child cols
                snsize[rp] = ns
                first_cc[rp] = merged_rows       # merged panel height
                zeros[rp] = totzeros
                changed = True
    reps = sorted({int(find(s)) for s in range(nsuper)},
                  key=lambda s: int(super_[s]))
    starts = [int(super_[s]) for s in reps]
    return np.array(starts + [n], dtype=INDEX)


@spanned("plan.super_symbolic")
def super_symbolic(A: SparseCSC, sym: Symbolic,
                   common: Optional[Common] = None) -> SuperSymbolic:
    """Build the supernode partition and all numeric-phase maps.

    Works on the postordered, fill-permuted pattern; updates sym.perm to
    the combined permutation (fill perm then postorder) like
    cholmod_analyze does before super_symbolic.
    """
    cm = common or default_common()
    cm.checkpoint("super_symbolic")
    opts = cm.cholesky
    n = sym.n

    # --- postorder the etree so supernode columns are contiguous ----------
    post = sym.post
    perm2 = sym.perm[post]
    U = _force_upper(A) if A.stype == 0 else (A if A.stype > 0 else A.transpose())
    P = U.symperm(perm2, values=False).sort_indices()
    from ..graph import col_counts, etree, postorder as _postorder
    parent = etree(P)
    post2 = _postorder(parent)
    if not np.array_equal(post2, np.arange(n)):
        # apply remaining postorder (should be identity for a proper
        # postordered etree, but be safe)
        perm2 = perm2[post2]
        P = U.symperm(perm2, values=False).sort_indices()
        parent = etree(P)
    cc = col_counts(P, parent, _postorder(parent))
    sym.perm = perm2
    sym.parent = parent
    sym.colcount = cc
    sym.post = np.arange(n, dtype=INDEX)

    # --- fundamental supernodes (cholmod_super_symbolic.c:415-434) --------
    # vectorized: nchild via bincount; a column j starts a new supernode
    # unless parent[j-1]==j, colcount[j-1]==colcount[j]+1, one child
    nchild = np.bincount(np.where(parent >= 0, parent, n),
                         minlength=n + 1).astype(INDEX)
    j = np.arange(1, n)
    fundamental = ((parent[:-1] == j) & (cc[:-1] == cc[1:] + 1)
                   & (nchild[1:n] == 1))
    super_ = np.concatenate([[0], j[~fundamental], [n]]).astype(INDEX)

    # --- relaxed amalgamation (cholmod_super_symbolic.c:475-560) ----------
    nrelax0, nrelax1, nrelax2 = opts.nrelax
    zrelax0, zrelax1, zrelax2 = opts.zrelax
    nsuper = len(super_) - 1
    super_ = _amalgamate(n, nsuper, super_, parent, cc,
                         (nrelax0, nrelax1, nrelax2),
                         (zrelax0, zrelax1, zrelax2))
    nsuper = len(super_) - 1
    col_to_super = np.repeat(np.arange(nsuper, dtype=INDEX),
                             np.diff(super_))

    # --- supernodal etree + level schedule --------------------------------
    # Within any (relaxed) supernode every column except the LAST has its
    # etree parent inside the supernode (fundamental supernodes are etree
    # chains; relaxed merging only joins a child whose last column's parent
    # lies in the absorbing supernode).  Hence every below-row of s is an
    # ancestor of its last column, and the first row beyond s's columns is
    # exactly parent[last col]: sn_parent comes straight from the scalar
    # etree — no row structure needed yet.
    last_col = super_[1:] - 1
    pl = parent[last_col]
    sn_parent = np.where(pl >= 0, col_to_super[np.clip(pl, 0, n - 1)],
                         -1).astype(INDEX)
    depth = np.zeros(nsuper, dtype=INDEX)
    # depth from root: parents have larger indices (postordered), so iterate
    # descending — each parent's depth is final before its children need it
    for s in range(nsuper - 1, -1, -1):
        p = int(sn_parent[s])
        depth[s] = 0 if p == -1 else depth[p] + 1
    maxd = int(depth.max()) if nsuper else 0
    levels = [np.where(depth == d)[0].astype(INDEX)
              for d in range(maxd, -1, -1)]

    # --- supernodal row structure (level-batched union) -------------------
    # rows(s) = union over cols j in s of pattern(L[:,j]), computed
    # supernode-relationally: rows(s) = A-pattern of s's cols (>= first col)
    #   ∪ (rows(c) \ cols(c)) for children c, restricted to >= first col.
    # Processed leaves->root one LEVEL at a time: each level's unions are
    # ONE keyed np.unique over the concatenated (s, row) pairs — the
    # per-supernode Python np.unique loop was the 14 s analyze wall at
    # n=262k (VERDICT r3 missing #3).
    rows_list: list[np.ndarray] = [None] * nsuper
    children: list[list[int]] = [[] for _ in range(nsuper)]
    for c in range(nsuper):
        p = int(sn_parent[c])
        if p >= 0:
            children[p].append(c)
    # A-pattern per supernode (rows >= j1 across its columns, from lower
    # triangle of PAP' = transpose view of upper storage)
    Pl = P.transpose()  # lower triangle (stype flips; pattern only)
    key = np.int64(n + 1)
    for level in levels:
        parts = []
        for s in np.asarray(level).tolist():
            j1, j2 = int(super_[s]), int(super_[s + 1])
            base = s * key
            parts.append(base + np.arange(j1, j2, dtype=np.int64))
            lo, hi = int(Pl.indptr[j1]), int(Pl.indptr[j2])
            arows = Pl.indices[lo:hi]
            parts.append(base + arows[arows >= j2])
            for c in children[s]:
                rc = rows_list[c]
                parts.append(base + rc[np.searchsorted(rc, j2):])
        if not parts:
            continue
        keys = np.unique(np.concatenate(parts))
        sidx = keys // key
        bounds = np.searchsorted(sidx, np.asarray(level))
        bounds = np.append(bounds, len(keys))
        lrows = keys % key
        for k, s in enumerate(np.asarray(level).tolist()):
            rows_list[s] = lrows[bounds[k]:bounds[k + 1]].astype(
                INDEX, copy=False)
    sn_rowptr = np.zeros(nsuper + 1, dtype=INDEX)
    np.cumsum([len(r) for r in rows_list], out=sn_rowptr[1:])
    sn_rows = np.concatenate(rows_list) if nsuper else np.empty(0, dtype=INDEX)

    # --- padded bucket-contiguous panel layout ----------------------------
    shapes = [(int(sn_rowptr[s + 1] - sn_rowptr[s]),
               int(super_[s + 1] - super_[s])) for s in range(nsuper)]
    # bucket merging trades HBM for fewer instructions; when the unpadded
    # factor exceeds 256 MB (est * 4 bytes) merging turns OFF entirely —
    # at HBM scale the padded buffer + per-instruction workspace already
    # graze the 16 GB chip (lap3d_64: 6.1 GB merged OOMs one execution,
    # 5.3 GB unmerged runs)
    est = sum(ms * ns for ms, ns in shapes)
    bmerge = opts.bucket_merge if est * 4 < (256 << 20) else 0.0
    panel_off, panel_Np, panel_Mp, total, level_buckets, wave_w = \
        _assign_layout(levels, shapes, ladder=opts.shape_ladder,
                       bucket_merge=bmerge)

    ss = SuperSymbolic(
        n=n, nsuper=nsuper, super=super_, col_to_super=col_to_super,
        sn_rowptr=sn_rowptr, sn_rows=sn_rows, panel_off=panel_off,
        panel_Np=panel_Np, panel_Mp=panel_Mp,
        total=total, sn_parent=sn_parent, levels=levels,
        level_buckets=level_buckets, lnz_dense=total,
        a_scatter_dst=None, a_scatter_src=None, wave_w=wave_w,
        layout_opts=(opts.shape_ladder, bmerge))

    # --- A scatter map -----------------------------------------------------
    # tril(PAP') entry (i, j) -> normalized padded position in panel of
    # s = col_to_super[j]
    PL = U.symperm(sym.perm, values=False).transpose()  # lower, pattern only
    PL.sort_indices()
    nz = PL.nnz
    cols = np.repeat(np.arange(n, dtype=INDEX), np.diff(PL.indptr))
    rows = PL.indices
    s_of = col_to_super[cols].astype(np.int64)
    # one keyed searchsorted over ALL entries: the concatenated (s, row)
    # keys of sn_rows are globally sorted (s ascending, rows sorted per s),
    # so each entry's local row index is one binary search minus the
    # supernode's rowptr base (the per-supernode mask loop was O(nsuper*nz))
    keys_all = (np.repeat(np.arange(nsuper, dtype=np.int64),
                          np.diff(sn_rowptr)) * key
                + sn_rows.astype(np.int64))
    local = (np.searchsorted(keys_all, s_of * key + rows.astype(np.int64))
             - sn_rowptr[s_of])
    ns_of = np.diff(super_).astype(np.int64)[s_of]
    Np_of = panel_Np[s_of].astype(np.int64)
    norm = np.where(local < ns_of, local, Np_of + (local - ns_of))
    a_dst = (panel_off[s_of].astype(np.int64) + norm * Np_of
             + (cols.astype(np.int64) - super_[s_of]))
    ss.a_scatter_dst = a_dst.astype(INDEX)
    ss.a_scatter_src = np.arange(nz, dtype=INDEX)
    return ss
