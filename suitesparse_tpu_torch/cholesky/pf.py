"""Pass-forward (multifrontal) numeric program in PyTorch.

Counterpart of suitesparse_tpu/cholesky/pf.py.  The host plan -- update
buffer layout, per-bucket scatter/project mode, child->parent projection
maps and the stacked instruction stream -- is the reference's, copied, so
the port's plan and panel buffer are interchangeable with the reference's:

  * every supernode owns an (Mb x Mb) **update slot** in a bucket-
    contiguous update buffer appended to the panel buffer.  A child's
    Schur complement goes ONLY to its parent's frame (the multifrontal
    containment theorem, asserted at plan time) and the un-owned part is
    passed upward through the parent's own update;
  * the reference places a child's update into its parent's frame as
    patch = Wh U Whᵀ, Wh a one-hot row-placement matrix built on the fly
    from a static index array, by batched products per child group.  The
    port's pair projections (the default grouping) run that placement as
    ``extend_add``: the hand-written kernel ``csrc/pf_extend_add.cu`` on
    the card, a gather and a sum over the children, with no product;
    chunk-grouped projections keep the one-hot products;
  * small-update buckets keep a 1-HOP sorted-segment scatter (into the
    parent frame only) -- chosen per bucket by the reference's cost model,
    whose TPU-calibrated constants are kept so that the plans match.

Program form.  The reference compiles the instruction stream in four XLA
forms (unroll / scan / vm / runs) that exist only for XLA compile cost.
The port has ONE straight-line form: a Python loop over the instruction
stream that updates the flat factor buffer in place where the reference
relied on dynamic_update_slice aliasing.  ``pf_program`` makes it a device
program (utils/programs.py): captured once per plan into a CUDA graph and
replayed for every refactorization on the card.

Phase scopes.  The assembly and each piece of a factor wave run inside a
``torch.profiler.record_function`` range labelled as the reference's
``jax.named_scope`` (``Assemble``, ``Fslice8x32``, ...), and each pair
projection's extend-add inside one range named for its class
(``Qextend32g8``, where the reference has ``Qgather``, ``QplaceW``,
``QplaceR``, ``Qeinsum`` and ``Qscat``), so that
``tools/profile_attrib.py`` can attribute the device time of the eager
body by phase.  A range is host code only: a captured graph holds none
of it.  It is entered only while a profiler records (``_scope``,
``utils/trace.scope``); otherwise it costs one flag test.

Update-slot convention: a slot holds the accumulated incoming update in
LOWER-triangle-canonical form until its supernode factors (the factor
step symmetrizes), then the FULL symmetric outgoing update U = B Bᵀ+acc.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..core.sparse import INDEX
from ..utils import cuda_build
from ..utils.device import resolve_device, torch_dtype
from ..utils.programs import DeviceProgram, cached_program
from ..utils.trace import scope as _scope
from ..utils.trace import spanned
from .kernels import block_chol, panel_factor
from .super_numeric import (NumericPlan, _device_amaps, _index, _panels,
                            _seg_lengths, assemble, cholesky_or_nan,
                            scatter_add_maps, segment_sum, syrk)

__all__ = ["PFPlan", "block_chol_shapes", "build_pf_plan", "extend_add",
           "extend_add_launches", "extend_add_plain", "pf_numeric",
           "pf_program"]

# Largest panel column class factored by panel_factor (block_chol on
# 128-wide slabs); wider classes take torch.linalg's batched Cholesky and
# triangular solve, as the reference's SSTPU_POTRF_MAXNP default does.
_POTRF_MAXNP = 8192


def block_chol_shapes(pfp) -> dict:
    """{(W, Np): launches} of block_chol in one factor of the plan ``pfp``
    (the default ``trsm_inv`` route): each factor class at Np <=
    _POTRF_MAXNP launches once per 128-wide slab (fewer columns: once)."""
    nf = len(pfp.fmeta)
    shapes = {}
    for cid in pfp.instr_cls.tolist():
        if cid >= nf:
            continue
        Np, Mb, W = pfp.fmeta[cid][:3]
        if Np <= _POTRF_MAXNP:
            bb = min(Np, 128)
            shapes[(W, bb)] = shapes.get((W, bb), 0) + Np // bb
    return shapes


def extend_add_launches(pfp) -> int:
    """Launches of ``extend_add`` in one factor of the plan ``pfp``: one a
    pair instruction."""
    return int(np.count_nonzero(
        pfp.instr_cls >= len(pfp.fmeta) + len(pfp.pmeta)))


def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _pad_to(a: np.ndarray, length: int, fill) -> np.ndarray:
    out = np.full((length,) + a.shape[1:], fill, dtype=a.dtype)
    out[:len(a)] = a
    return out



# ---------------------------------------------------------------------------
# Host planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PFPlan:
    plan: NumericPlan
    fmeta: tuple        # per factor class: (Np, Mb, W, mode, L, K)
    fops: list          # per factor class: dict of stacked host arrays
    pmeta: tuple        # per proj class: (Wc, Mbc, Wp, Npt, Mbt, G)
    pops: list          # per proj class: dict of stacked host arrays
    qmeta: tuple = ()   # per PAIR class: (Mbc, G, Pq, Npt, Mbt, pc, uc, spanq)
    qops: list = dataclasses.field(default_factory=list)
    instr_cls: np.ndarray = None  # class id per instruction: [f | p | q]
    instr_pos: np.ndarray = None  # position within the class stack
    buf: int = 0
    ub_total: int = 0
    proj_flops: float = 0.0   # projection flop count (diagnostic)
    scat_entries: int = 0     # 1-hop scatter entry count (diagnostic)
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def meta(self):
        return (self.fmeta, self.pmeta, self.qmeta)

    def arrays(self, dtype, device):
        """Per-class operands of the device program, cached per (dtype,
        device).  Offsets used to slice the flat buffer stay host ints;
        index maps become int64 tensors on ``device``."""
        dt, dev = torch_dtype(dtype), torch.device(device)
        key = (dt, dev)
        got = self._cache.get(key)
        if got is None:
            got = (tuple(_factor_ops(o, m, dt, dev)
                         for o, m in zip(self.fops, self.fmeta)),
                   tuple(_proj_ops(o, dev) for o in self.pops),
                   tuple(_pair_ops(o, m, self.buf, dev)
                         for o, m in zip(self.qops, self.qmeta)))
            self._cache[key] = got
        return got


def _factor_ops(ops, meta, dt, dev):
    Np, Mb, W, mode, L, K = meta
    out = dict(base=ops["base"].tolist(), ubs=ops["ubs"].tolist())
    for name in ("padeye", "rowmask", "colmask"):
        out[name] = torch.as_tensor(ops[name], dtype=dt, device=dev)
    if L:
        out.update(
            src=_index(ops["src"], dev), dst=_index(ops["dst"], dev),
            sgn=torch.as_tensor(ops["sgn"], dtype=dt, device=dev),
            lens=torch.stack([_seg_lengths(i, K, dev) for i in ops["ids"]]))
    return out


def _proj_ops(ops, dev):
    return dict(cub=ops["cub"].tolist(), pbase=ops["pbase"].tolist(),
                pub=ops["pub"].tolist(), csel=_index(ops["csel"], dev),
                idxf=_index(ops["idxf"], dev))


def _pair_ops(ops, meta, buf, dev):
    """Operands of a pair class's extend-add, stacked per instruction: the
    frame row maps ``idxf`` (int32), the child slab offsets ``coff`` and
    the parent panel and update-slot offsets ``pdst`` and ``udst``, -1
    where the slab lies past the buffer: the plan's pad parents, which the
    reference's scatter drops (FILL_OR_DROP)."""
    Mbc, G, Pq, Npt, Mbt = meta[:5]

    def dest(d, length):
        return _index(np.where(d + length <= buf, d, -1), dev)
    out = dict(idxf=torch.as_tensor(ops["idxf"], dtype=torch.int32,
                                    device=dev),
               coff=_index(ops["uoff"], dev),
               pdst=dest(ops["pdst"], (Npt + Mbt) * Npt))
    if Mbt:
        out["udst"] = dest(ops["udst"], Mbt * Mbt)
    return out


def _dest_1hop(ss, rows_of, where, ub_slot_of, b, total: int, trash: int):
    """1-hop extend-add targets for one bucket: entry (i, c) of supernode
    s's update goes to the PARENT frame — its panel when the target column
    is a parent pivot column, else the parent's update slot (lower
    triangle only; the slot is lower-canonical until the parent factors).
    """
    sup = ss.super
    B, Mb = len(b.sids), b.Mb
    dest = np.full((B, Mb, Mb), trash, dtype=INDEX)
    parent = np.asarray(ss.sn_parent)
    for k, s in enumerate(np.asarray(b.sids).tolist()):
        ms, ns = ss.panel_shape(s)
        mb = ms - ns
        if not mb:
            continue
        r = rows_of[s][ns:]
        t = int(parent[s])
        assert t >= 0, "supernode with below rows lacks a parent"
        rows_t = rows_of[t]
        ns_t = int(sup[t + 1] - sup[t])
        j1_t = int(sup[t])
        loc = np.searchsorted(rows_t, r)
        ok = loc < len(rows_t)
        locc = np.clip(loc, 0, max(len(rows_t) - 1, 0))
        ok &= rows_t[locc] == r
        assert ok.all(), ("multifrontal containment violated: child below "
                          "rows must lie in the parent front")
        Npt = int(ss.panel_Np[t])
        Mbt = int(ss.panel_Mp[t]) - Npt
        frow = int(ss.panel_off[t]) + ss.norm_local(t, locc) * Npt
        is_col = locc < ns_t                   # target col owned by parent
        below = locc - ns_t                    # parent below-row index
        uoff = ub_slot_of[t]
        ar = np.arange(mb)
        # panel targets: (i, c) with is_col[c]; rows i >= c (lower tri)
        d_panel = frow[:, None] + (r - j1_t)[None, :]
        # update-slot targets: both below; lower tri of the parent slot
        d_ub = uoff + below[:, None] * Mbt + below[None, :]
        d = np.where(is_col[None, :], d_panel, d_ub)
        valid = ar[:, None] >= ar[None, :]
        dest[k, :mb, :mb] = np.where(valid, d, trash)
    return dest


@spanned("plan.pf_plan")
def build_pf_plan(plan: NumericPlan, common=None) -> PFPlan:
    """Host planning, once per pattern: update-buffer layout, per-bucket
    scatter/project mode decision, child->parent projection maps grouped
    by (child bucket, parent chunk), and the stacked instruction stream."""
    from ..core.common import default_common
    cm = common or default_common()
    opts = cm.cholesky
    ss = plan.ss
    n, total = plan.n, plan.total
    sup = ss.super
    parent = np.asarray(ss.sn_parent)
    rows_of = [ss.rows_of(s) for s in range(ss.nsuper)]

    # supernode -> (level, bucket idx, slot)
    where = {}
    for li, lv in enumerate(plan.levels):
        for bi, b in enumerate(lv):
            for slot, s in enumerate(b.sids.tolist()):
                where[int(s)] = (li, bi, slot)

    # --- update-buffer layout (mirrors the panel bucket layout) ----------
    ub_base = {}
    off = total
    for li, lv in enumerate(plan.levels):
        for bi, b in enumerate(lv):
            if b.Mb:
                nw = -(-len(b.sids) // b.W)
                ub_base[(li, bi)] = off
                off += nw * b.W * b.Mb * b.Mb
    ub_total = off - total
    trash = off
    # per-supernode update-slot base (for 1-hop scatter targets)
    ub_slot_of = np.full(ss.nsuper, -1, dtype=np.int64)
    for li, lv in enumerate(plan.levels):
        for bi, b in enumerate(lv):
            if b.Mb:
                base = ub_base[(li, bi)]
                for slot, s in enumerate(b.sids.tolist()):
                    ub_slot_of[int(s)] = base + slot * b.Mb * b.Mb

    # --- per-bucket mode + instruction enumeration ------------------------
    CAP = 24 << 20       # working floats per instruction slice
    # projection workspace budget: generous for small factors (fewer,
    # fatter instructions), tight when the factor buffer itself is HBM-
    # scale (lap3d_64's 7 GB buffer + 1.2 GB workspace OOM'd a 16 GB chip)
    PCAP = 4 * CAP if total * 4 < (2 << 30) else CAP
    f_instrs = []        # (key, ops) in schedule order, tag 'f'
    p_instrs = []        # (key, ops) tag 'p'
    q_instrs = []        # (key, ops) tag 'q' (pair-grouped projections)
    stream = []          # ('f'|'p'|'q', index into the tag list)
    proj_flops = 0.0
    scat_entries = 0
    pair = opts.pf_group == "pair"

    for li, lv in enumerate(plan.levels):
        lv_f = []            # level-local stream: indices into f_instrs
        lv_p = []            # ... into p_instrs
        lv_q = []            # ... into q_instrs
        lv_proj = []
        lv_pairs = {}        # (Mbc, bj) -> [(uoff, slotp, s, t), ...]
        for bi, b in enumerate(lv):
            Np, Mb, B, W = b.Np, b.Mb, len(b.sids), b.W
            Mp = Np + Mb
            nw = -(-B // W)
            mode = 0
            groups = {}
            if Mb:
                # group children by (parent bucket, parent chunk, child win)
                pb_of = {}
                child_list = []      # (slot, s, t, lj, bj, slotp)
                for slot, s in enumerate(b.sids.tolist()):
                    ms, ns = ss.panel_shape(s)
                    if ms == ns:
                        continue     # no below rows (bucket-merge padding)
                    t = int(parent[s])
                    lj, bj, slotp = where[t]
                    assert lj == li + 1, "parent must be on the next level"
                    child_list.append((slot, int(s), t, bj, slotp))
                # per-pair chunk sizes
                est_flops = 0.0
                for slot, s, t, bj, slotp in child_list:
                    pb = plan.levels[li + 1][bj]
                    Mft = pb.Np + pb.Mb
                    est_flops += 2.0 * Mft * pb.Np * Mb + \
                        2.0 * pb.Mb * pb.Mb * Mb
                ent = int(sum(
                    (ss.panel_shape(s)[0] - ss.panel_shape(s)[1]) ** 2
                    for s in b.sids.tolist())) // 2
                t_scat = ent * 4.0 * 3.0 / opts.pf_scatter_bw
                t_proj = est_flops / opts.pf_proj_rate
                mode = 1 if (opts.pf_mode == "project"
                             or (opts.pf_mode == "auto"
                                 and t_proj < t_scat)) else 2
                if mode == 1 and pair:
                    for slot, s, t, bj, slotp in child_list:
                        pb = plan.levels[li + 1][bj]
                        lv_pairs.setdefault(
                            (Mb, pb.Np, pb.Mb), {}).setdefault(
                            (bj, slotp), []).append(
                            (int(ub_slot_of[s]), s, t))
                elif mode == 1:
                    # child window size for the update-stack slice
                    Wc_tot = nw * W
                    Wc = Wc_tot
                    while Wc > 1 and Wc * Mb * Mb > CAP:
                        Wc = (Wc + 1) // 2
                    Wc = _pow2ceil(Wc)
                    for slot, s, t, bj, slotp in child_list:
                        pb = plan.levels[li + 1][bj]
                        Mft = pb.Np + pb.Mb
                        Wp = pb.W
                        # cap includes the (Wp, G, Mft, Mbc) batched
                        # placement workspace (G bounded by 8 below)
                        while Wp > 1 and Wp * Mft * max(8 * Mb, pb.Np) > \
                                4 * CAP:
                            Wp //= 2
                        wc = slot // Wc
                        cp = slotp // Wp
                        key = (bj, cp, wc, Wp)
                        groups.setdefault(key, {}).setdefault(
                            slotp - cp * Wp, []).append((slot - wc * Wc, s, t))
            # ---- factor instructions (one per wave) ----------------------
            ubb = ub_base.get((li, bi), 0)
            if mode == 2:
                dest = _dest_1hop(ss, rows_of, where, ub_slot_of, b,
                                  total, trash)
                scat_entries += ent
            for w in range(nw):
                lo, hi = w * W, min((w + 1) * W, B)
                breal = hi - lo
                padeye = np.ones((W, Np))
                padeye[:breal] = b.padeye[lo:hi]
                rowmask = np.zeros((W, Mp))
                rowmask[:breal] = b.rowmask[lo:hi]
                colmask = np.zeros((W, Np))
                colmask[:breal] = b.colmask[lo:hi]
                ops = dict(base=b.base + lo * Mp * Np,
                           ubs=ubb + lo * Mb * Mb,
                           padeye=padeye, rowmask=rowmask, colmask=colmask)
                if mode == 2:
                    src, ids, dst = scatter_add_maps(
                        dest[lo:hi].reshape(-1), trash)
                    ops.update(src=src, ids=ids, dst=dst)
                key = (Np, Mb, W, mode)
                lv_f.append(len(f_instrs))
                f_instrs.append((key, ops))
            # ---- projection instructions (after this bucket's factor) ----
            if mode == 1:
                Wc_tot = nw * W
                for (bj, cp, wc, Wp), slots_all in sorted(groups.items()):
                  gmax_all = max(len(v) for v in slots_all.values())
                  for gch in range(-(-gmax_all // 8)):
                    # G capped at 8 per instruction (bounds the batched
                    # placement workspace); overflow children go to a
                    # further instruction on the same parent chunk
                    slots = {sp: lst[gch * 8:(gch + 1) * 8]
                             for sp, lst in slots_all.items()
                             if len(lst) > gch * 8}
                    pb = plan.levels[li + 1][bj]
                    Npt, Mbt = pb.Np, pb.Mb
                    Mft = Npt + Mbt
                    G = _pow2ceil(max(len(v) for v in slots.values()))
                    csel = np.full((Wp, G), Wc, dtype=np.int32)
                    idxf = np.full((Wp, G, Mft), Mb, dtype=np.int32)
                    for slotp_rel, childs in slots.items():
                        t = childs[0][2]
                        rows_t = rows_of[t]
                        ns_t = int(sup[t + 1] - sup[t])
                        for g, (slot_rel, s, _t) in enumerate(childs):
                            csel[slotp_rel, g] = slot_rel
                            ms, ns = ss.panel_shape(s)
                            mb = ms - ns
                            r = rows_of[s][ns:]
                            loc = np.searchsorted(rows_t, r)
                            ok = (loc < len(rows_t))
                            locc = np.clip(loc, 0, max(len(rows_t) - 1, 0))
                            ok &= rows_t[locc] == r
                            assert ok.all(), "containment violated"
                            fpos = np.where(locc < ns_t, locc,
                                            Npt + (locc - ns_t))
                            idxf[slotp_rel, g, fpos] = np.arange(
                                mb, dtype=np.int32)
                            proj_flops += (2.0 * Mft * Npt * Mb
                                           + 2.0 * Mbt * Mbt * Mb)
                    ops = dict(cub=ub_base[(li, bi)] + wc * Wc * Mb * Mb,
                               pbase=pb.base + cp * Wp * (Npt + Mbt) * Npt,
                               pub=(ub_base.get((li + 1, bj), 0)
                                    + cp * Wp * Mbt * Mbt),
                               csel=csel, idxf=idxf)
                    key = (Wc, Mb, Wp, Npt, Mbt, G)
                    lv_p.append(len(p_instrs))
                    p_instrs.append((key, ops))

        # ---- pair-grouped projections (after ALL of the level's factors):
        # parent-blocked contraction — children of each parent ride the
        # einsum contraction axis (G), so the patch materializes PER PARENT
        # (P,Mft,Npt), never per child.  Parents are classed by pow2(G) and
        # chunked into contiguous slot windows; children may come from any
        # same-Mb bucket of the level (global slab gather by offset).
        for (Mbc, Npt, Mbt), par_all in sorted(lv_pairs.items()):
            Mft = Npt + Mbt
            # G-axis workspace cap: a single parent with many children can
            # exceed the budget at any P, so children beyond gcap go to
            # follow-up ROUNDS (same parent, separate instructions — the
            # scatter-adds accumulate, and per-round uniqueness holds)
            unit_g = Mft * 2 * Mbc + Mbc * Mbc + 2 * Mft * Npt \
                + Mbt * Mbt
            gcap = 1
            while gcap * 2 * unit_g <= PCAP:
                gcap *= 2
            rounds = max(-(-len(v) // gcap) for v in par_all.values())
            for rnd in range(rounds):
              par = {bs: v[rnd * gcap:(rnd + 1) * gcap]
                     for bs, v in par_all.items() if len(v) > rnd * gcap}
              # G partition, cost-modelled: either ONE class padded to the
              # pair's Gmax, or a pow2 ladder of classes.  Padded G rows
              # are zeros (flops+data), extra classes are extra
              # instructions (~30us dispatch) — pick the cheaper time.
              gs = [len(v) for v in par.values()]
              gmax = _pow2ceil(max(gs))
              pad_single = sum(gmax - g for g in gs)
              pad_pow2 = sum(_pow2ceil(g) - g for g in gs)
              ncls_pow2 = len({_pow2ceil(g) for g in gs})
              unit_cost = 2.0 * Mbc * (Mft * Npt + Mbt * Mbt) / 3e13 \
                  + 2.0 * Mft * Mbc * 4 / 5e11
              single = (pad_single - pad_pow2) * unit_cost \
                  < (ncls_pow2 - 1) * 30e-6
              by_g = {}
              for bs in sorted(par):
                  g = gmax if single else _pow2ceil(len(par[bs]))
                  by_g.setdefault(g, []).append((bs, par[bs]))
              for G, plist in sorted(by_g.items()):
                  # gap-fill (round-5): a parent slot with no children in
                  # this G-class breaks the destination run and forces the
                  # slow scatter mode.  Filling gaps with empty parents
                  # (all-pad idxf rows contribute exact zeros) restores
                  # contiguity when the fill stays under 2x — einsum pad
                  # flops are ~3% of program time, the scatter it replaces
                  # was 12%.
                  import itertools as _it
                  filled = []
                  for bj_, grp in _it.groupby(plist, key=lambda e: e[0][0]):
                      grp = list(grp)
                      sps = {e[0][1]: e for e in grp}
                      lo_, hi_ = min(sps), max(sps)
                      if hi_ - lo_ + 1 <= 2 * len(grp):
                          filled.extend(sps.get(sp, ((bj_, sp), []))
                                        for sp in range(lo_, hi_ + 1))
                      else:
                          filled.extend(grp)
                  plist = filled
                  unit = G * Mft * 2 * Mbc + G * Mbc * Mbc \
                      + 2 * Mft * Npt + Mbt * Mbt
                  cap_p = max(1, PCAP // unit)
                  for p0 in range(0, len(plist), cap_p):
                      ppart = plist[p0:p0 + cap_p]
                      P = len(ppart)
                      Pq = _pow2ceil(P)
                      uoff = np.full((Pq, G), -1, dtype=INDEX)
                      idxf = np.full((Pq, G, Mft), Mbc, dtype=np.int32)
                      # absolute slab destinations; parent pads point past
                      # the buffer end and are dropped by the scatter mode.
                      # Pad sentinels are DISTINCT (and ascending) so the
                      # scatter's unique_indices promise holds even before
                      # FILL_OR_DROP discards them — duplicate indices are
                      # undefined behavior under that promise.
                      pdst = ((1 << 40)
                              + np.arange(Pq, dtype=INDEX) * (Mft * Npt))
                      udst = ((1 << 40)
                              + np.arange(Pq, dtype=INDEX) * max(Mbt * Mbt, 1))
                      for k, ((bj, sp), childs) in enumerate(ppart):
                          pb = plan.levels[li + 1][bj]
                          pdst[k] = pb.base + sp * Mft * Npt
                          udst[k] = ub_base.get((li + 1, bj), 0) \
                              + sp * Mbt * Mbt
                          if not childs:      # gap-fill parent: all pads
                              continue
                          t = childs[0][2]
                          rows_t = rows_of[t]
                          ns_t = int(sup[t + 1] - sup[t])
                          uoff[k, :] = childs[0][0]
                          for g, (uo, s, _t) in enumerate(childs):
                              uoff[k, g] = uo
                              ms, ns = ss.panel_shape(s)
                              mb = ms - ns
                              r = rows_of[s][ns:]
                              loc = np.searchsorted(rows_t, r)
                              ok = loc < len(rows_t)
                              locc = np.clip(loc, 0, max(len(rows_t) - 1, 0))
                              ok &= rows_t[locc] == r
                              assert ok.all(), "containment violated"
                              fpos = np.where(locc < ns_t, locc,
                                              Npt + (locc - ns_t))
                              idxf[k, g, fpos] = np.arange(mb, dtype=np.int32)
                              proj_flops += 2.0 * Mft * Npt * Mbc \
                                  + 2.0 * Mbt * Mbt * Mbc
                      real_u = uoff >= 0
                      assert real_u.any(), "pair chunk with no children"
                      fill_u = uoff[real_u][0]
                      uoff[~real_u] = fill_u   # pads read a real slab;
                      # their idxf rows select nothing -> contribute zero
                      ops = dict(uoff=uoff, idxf=idxf, pdst=pdst, udst=udst)
                      # span-mode gather (round-5 profile: per-slab
                      # vmap'd dynamic_slice gathers measured 32 GB/s at
                      # lap3d_28).  When every child slab of the chunk
                      # sits on one Mbc^2 grid inside a bounded span, the
                      # gather becomes ONE streamed dynamic-slice + a
                      # large-row take.  Span slab count pads to pow2 so
                      # classes stay few.
                      ssz = Mbc * Mbc
                      m0 = int(uoff[real_u].min())
                      span = int(uoff[real_u].max()) + ssz - m0
                      nslab = span // ssz
                      vol = Pq * G
                      gc0 = bool(np.all((uoff[real_u] - m0) % ssz == 0)
                                 and nslab <= max(2 * vol, 8)
                                 and span <= 4 * CAP)
                      spanq = _pow2ceil(max(nslab, 1)) if gc0 else 0
                      if gc0:
                          ops["g0"] = m0
                          ops["gsel"] = ((uoff - m0) // ssz).astype(
                              np.int32)
                      # contiguity detection (round-5, from the device
                      # profile: the slab scatter-add was 12% of program
                      # time at lap3d_28).  When the chunk's parent slots
                      # are consecutive — the common case, since ppart is
                      # (bucket, slot)-sorted over full chunks — the
                      # patch lands as ONE dynamic-slice read-modify-write
                      # at HBM stream bandwidth instead of a scatter.
                      # Pad rows continue the run and subtract exact
                      # zeros (their idxf selects the zero row), which is
                      # a numeric no-op on whatever they cover.
                      L1, L2 = Mft * Npt, max(Mbt * Mbt, 1)
                      pc = bool(np.all(np.diff(pdst[:P]) == L1))
                      uc = bool(Mbt
                                and np.all(np.diff(udst[:P]) == L2))
                      if pc:
                          ops["pdst"] = (pdst[0]
                                         + np.arange(Pq, dtype=INDEX) * L1)
                      if uc:
                          ops["udst"] = (udst[0]
                                         + np.arange(Pq, dtype=INDEX) * L2)
                      key = (Mbc, G, Pq, Npt, Mbt, pc, uc, spanq)
                      lv_q.append(len(q_instrs))
                      q_instrs.append((key, ops))

        # ---- level stream: ALL factors, then all projections, grouped by
        # class.  Within a level every factor wave is independent and the
        # projections/scatters are commutative adds into level li+1, so the
        # reordering is semantics-preserving; grouping maximizes the
        # consecutive same-class RUNS that the "runs" program form rolls
        # into one fori-style loop each — one pallas_call INSTANCE per
        # class instead of one per instruction (the ~5 s/instance Mosaic
        # remote-compile wall, NOTES_ROUND4.md §8).  Stable sort keeps
        # per-class emission order, so class-stack positions stay
        # ascending within each run.
        stream.extend(("f", i) for i in
                      sorted(lv_f, key=lambda i: f_instrs[i][0]))
        stream.extend(("p", i) for i in
                      sorted(lv_p, key=lambda i: p_instrs[i][0]))
        stream.extend(("q", i) for i in
                      sorted(lv_q, key=lambda i: q_instrs[i][0]))

    # --- stack operands per class -----------------------------------------
    def stack(instrs, pad_scat=False):
        keys, by = [], {}
        for key, ops in instrs:
            if key not in by:
                by[key] = []
                keys.append(key)
            by[key].append(ops)
        cls_id = {k: i for i, k in enumerate(keys)}
        stacked = []
        kmax = 0
        for key in keys:
            ws = by[key]
            out = {}
            names = list(ws[0].keys())
            if pad_scat and "src" in names:
                L = max(len(w["src"]) for w in ws)
                K = max(len(w["dst"]) for w in ws) + 1
                kmax = max(kmax, K)
                srcs, idss, dsts, sgns = [], [], [], []
                for w in ws:
                    k = len(w["dst"])
                    srcs.append(_pad_to(w["src"], L, 0))
                    idss.append(_pad_to(w["ids"], L, max(K - 1, 0)))
                    dpad = np.concatenate([
                        w["dst"],
                        trash + 1 + np.arange(K - k, dtype=INDEX)])
                    dsts.append(dpad.astype(INDEX))
                    sgns.append(np.where(dpad < total, -1.0, 1.0))
                out.update(src=np.stack(srcs), ids=np.stack(idss),
                           dst=np.stack(dsts), sgn=np.stack(sgns))
                names = [x for x in names if x not in ("src", "ids", "dst")]
                key = key + (L, K)
            elif pad_scat:
                key = key + (0, 0)
            for name in names:
                vals = [w[name] for w in ws]
                out[name] = (np.array(vals, dtype=INDEX)
                             if np.isscalar(vals[0]) else np.stack(vals))
            stacked.append((key, out))
        pos = {k: 0 for k in keys}
        return keys, cls_id, stacked, pos, kmax

    fkeys, fid, fstk, fpos_ctr, kmax = stack(f_instrs, pad_scat=True)
    pkeys, pid, pstk, ppos_ctr, _ = stack(p_instrs)
    qkeys, qid, qstk, qpos_ctr, _ = stack(q_instrs)

    T = len(stream)
    instr_cls = np.empty(T, dtype=np.int32)
    instr_pos = np.empty(T, dtype=np.int32)
    nf = len(fkeys)
    npc = len(pkeys)
    for t, (tag, i) in enumerate(stream):
        key = {"f": f_instrs, "p": p_instrs, "q": q_instrs}[tag][i][0]
        if tag == "f":
            instr_cls[t] = fid[key]
            instr_pos[t] = fpos_ctr[key]
            fpos_ctr[key] += 1
        elif tag == "p":
            instr_cls[t] = nf + pid[key]
            instr_pos[t] = ppos_ctr[key]
            ppos_ctr[key] += 1
        else:
            instr_cls[t] = nf + npc + qid[key]
            instr_pos[t] = qpos_ctr[key]
            qpos_ctr[key] += 1

    # buffer: panels | update slots | trash region; extend for any slice
    # overrun from pow2 window rounding (reads there are never selected,
    # writes there are identity)
    buf = trash + 1 + kmax
    for (Wcw, Mbc, Wp, Npt, Mbt, G), ops in pstk:
        Mpt = Npt + Mbt
        buf = max(buf,
                  int(np.max(ops["cub"])) + Wcw * Mbc * Mbc,
                  int(np.max(ops["pbase"])) + Wp * Mpt * Npt,
                  (int(np.max(ops["pub"])) + Wp * Mbt * Mbt) if Mbt else 0)
    for (Mbc, G, Pq, Npt, Mbt, pc, uc, spanq), ops in qstk:
        # contiguous-run pad rows extend past the last real slot; their
        # zero-subtract touches whatever lies there, so the buffer must
        # cover the full span (same for the span-mode gather read)
        if pc:
            buf = max(buf, int(np.max(ops["pdst"])) + (Npt + Mbt) * Npt)
        if uc:
            buf = max(buf, int(np.max(ops["udst"])) + Mbt * Mbt)
        if spanq:
            buf = max(buf, int(np.max(ops["g0"])) + spanq * Mbc * Mbc)
    return PFPlan(plan=plan,
                  fmeta=tuple(k for k, _ in fstk),
                  fops=[o for _, o in fstk],
                  pmeta=tuple(k for k, _ in pstk),
                  pops=[o for _, o in pstk],
                  qmeta=tuple(k for k, _ in qstk),
                  qops=[o for _, o in qstk],
                  instr_cls=instr_cls, instr_pos=instr_pos,
                  buf=int(buf), ub_total=int(ub_total),
                  proj_flops=proj_flops, scat_entries=scat_entries)



# ---------------------------------------------------------------------------
# Device program
# ---------------------------------------------------------------------------

def _tri_inv_pow2(C: torch.Tensor, base: int = 2) -> torch.Tensor:
    """Batched lower-triangular inverse via batch-folded block recursion:

        inv([[A,0],[B,D]]) = [[iA, 0], [-iD B iA, iD]]

    folding the batch down to 2x2 diagonal blocks inverted in closed form,
    then rebuilding with log2(Np/2) levels of batched products; a TRSM
    then becomes one product against L^-T.  Np must be a power of two
    (the coarse shape ladder guarantees 8/32/128)."""
    W, Np, _ = C.shape
    blocks = C
    stack = []
    m = Np
    while m > base:
        h = m // 2
        stack.append(blocks[:, h:, :h])
        blocks = torch.cat([blocks[:, :h, :h], blocks[:, h:, h:]], dim=0)
        m = h
    if m == 2:
        # inv([[a,0],[b,d]]) = [[1/a, 0], [-b/(a d), 1/d]] -- elementwise
        ia = 1.0 / blocks[:, 0, 0]
        idd = 1.0 / blocks[:, 1, 1]
        off = -blocks[:, 1, 0] * ia * idd
        z = torch.zeros_like(ia)
        inv = torch.stack([torch.stack([ia, z], dim=1),
                           torch.stack([off, idd], dim=1)], dim=1)
    else:
        eye = torch.eye(m, dtype=C.dtype, device=C.device).expand_as(blocks)
        inv = torch.linalg.solve_triangular(blocks, eye, upper=False)
    while stack:
        Bblk = stack.pop()
        half = inv.shape[0] // 2
        iA, iD = inv[:half], inv[half:]
        iB = -((iD @ Bblk) @ iA)
        h = Bblk.shape[2]
        top = torch.cat([iA, C.new_zeros((half, h, Bblk.shape[1]))], dim=2)
        bot = torch.cat([iB, iD], dim=2)
        inv = torch.cat([top, bot], dim=1)
    return inv


def _factor_step(Np, Mb, W, mode, L, K, bf16=False, trsm_inv=True):
    """One factor wave: POTRF + TRSM (panel_factor, whose diagonal blocks
    go through the block_chol kernel; with ``trsm_inv`` False, or above
    _POTRF_MAXNP, torch.linalg's Cholesky and triangular solve), SYRK
    (from bfloat16 inputs when ``bf16``) plus the lower-canonical incoming
    update, the panel write, and either the published full update (mode
    1) or the 1-hop sorted-segment scatter (mode 2).  Each piece runs in a
    ``_scope`` named as the reference's named scope (``Fslice``,
    ``Fpotrf``, ``Fsyrk``, ``Fwrite``, ``Fscat`` + f"{Np}x{Mb}")."""
    Mp = Np + Mb
    sl, po, sy, wr, sc = (f"{k}{Np}x{Mb}" for k in
                          ("Fslice", "Fpotrf", "Fsyrk", "Fwrite", "Fscat"))

    def step(Fx, pos, ops):
        pe = ops["padeye"][pos]
        rm = ops["rowmask"][pos]
        cmk = ops["colmask"][pos]
        with _scope(sl):
            P = _panels(Fx, ops["base"][pos], W, Mp, Np)
        with _scope(po):
            if trsm_inv and Np <= _POTRF_MAXNP:
                newP = panel_factor(P, pe, rm, cmk)     # masked output
            else:
                # the upper triangle of the diagonal block may hold junk
                T = torch.tril(P[:, :Np, :])
                Tfull = T + torch.tril(T, -1).transpose(1, 2)
                C = cholesky_or_nan(Tfull + torch.diag_embed(pe))
                if Mb:
                    Bm = torch.linalg.solve_triangular(
                        C.transpose(1, 2), P[:, Np:, :], upper=True,
                        left=False)
                    newP = torch.cat([C, Bm], dim=1)
                else:
                    newP = C
                newP = newP * rm[:, :, None] * cmk[:, None, :]
        if Mb:
            with _scope(sy):
                Bm = newP[:, Np:, :]
                slot = _panels(Fx, ops["ubs"][pos], W, Mb, Mb)
                acc = torch.tril(slot)   # lower-canonical incoming updates
                U = syrk(Bm, bf16) + acc + torch.tril(acc, -1).transpose(1, 2)
        with _scope(wr):
            P.copy_(newP)
            if Mb and mode == 1:
                slot.copy_(U)            # publish the full symmetric update
        if Mb and mode == 2 and L:
            with _scope(sc):
                seg = segment_sum(U.reshape(-1)[ops["src"][pos]],
                                  ops["lens"][pos])
                # sorted, unique targets: one write per entry, no atomics
                dst = ops["dst"][pos]
                Fx[dst] += seg * ops["sgn"][pos]
    return step


def _proj_step(Wc, Mbc, Wp, Npt, Mbt, G):
    """Chunk-grouped projection (pf_group="chunk"): children of a parent
    chunk gathered from the child window, placed by one-hot products."""
    Mft = Npt + Mbt

    def step(Fx, pos, ops):
        Uc = _panels(Fx, ops["cub"][pos], Wc, Mbc, Mbc)
        Ucz = torch.cat([Uc, Uc.new_zeros((1, Mbc, Mbc))], dim=0)
        idxf = ops["idxf"][pos]                         # (Wp, G, Mft)
        Ug = Ucz[ops["csel"][pos]]                      # (Wp, G, Mbc, Mbc)
        Ugz = torch.cat([Ug, Ug.new_zeros((Wp, G, 1, Mbc))], dim=2)
        R = torch.gather(Ugz, 2, idxf[..., None].expand(Wp, G, Mft, Mbc))
        mcols = torch.arange(Mbc, device=Fx.device)
        Wh = (idxf[..., None] == mcols).to(Fx.dtype)    # (Wp, G, Mft, Mbc)
        ppatch = torch.einsum("kgfm,kghm->kfh", R, Wh[:, :, :Npt, :])
        _panels(Fx, ops["pbase"][pos], Wp, Mft, Npt).sub_(ppatch)
        if Mbt:
            tpatch = torch.einsum("kgfm,kghm->kfh", R[:, :, Npt:, :],
                                  Wh[:, :, Npt:, :])
            _panels(Fx, ops["pub"][pos], Wp, Mbt, Mbt).add_(
                torch.tril(tpatch))
    return step


def _slab_add(Fx, dst, updates):
    """Add the (P, L) slabs ``updates`` into the flat buffer at the offsets
    ``dst`` (P,), skipping those at -1; the kept slabs do not overlap, so
    each entry is written once."""
    keep = dst >= 0
    L = updates.shape[1]
    idx = (dst[keep][:, None] + torch.arange(L, device=Fx.device))
    Fx[idx.reshape(-1)] += updates[keep].reshape(-1)


def extend_add_plain(Fx, idxf, coff, pdst, udst, Mbc: int, Npt: int,
                     Mbt: int, bf16: bool = False) -> None:
    """Plain PyTorch ``extend_add``: the same gathers and sums with tensor
    ops.  Each child slab is gathered by offset and padded with a zero row
    and column at index Mbc (a frame row the child lacks), its rows and
    then its columns placed by ``idxf``, and the children summed in the
    order g = 0, 1, ...; the sum leaves the panel and joins the update
    slot's lower triangle."""
    Pq, G, Mft = idxf.shape
    ix = idxf.long()
    U = Fx[coff[..., None] + torch.arange(Mbc * Mbc, device=Fx.device)]
    U = U.view(Pq, G, Mbc, Mbc)
    if bf16:
        U = U.to(torch.bfloat16).to(Fx.dtype)
    R = torch.gather(torch.nn.functional.pad(U, (0, 1, 0, 1)), 2,
                     ix[..., None].expand(Pq, G, Mft, Mbc + 1))

    def placed(lo, width):
        # frame rows lo.. by frame columns lo..lo + width, summed over g
        T = torch.gather(R[:, :, lo:], 3, ix[:, :, None, lo:lo + width]
                         .expand(Pq, G, Mft - lo, width))
        S = T[:, 0]
        for g in range(1, G):
            S = S + T[:, g]
        return S
    _slab_add(Fx, pdst, -placed(0, Npt).reshape(Pq, Mft * Npt))
    if Mbt:
        _slab_add(Fx, udst,
                  torch.tril(placed(Npt, Mbt)).reshape(Pq, Mbt * Mbt))


def extend_add(Fx, idxf, coff, pdst, udst, Mbc: int, Npt: int, Mbt: int,
               bf16: bool = False) -> None:
    """The extend-add of one pair instruction, in place on the flat buffer
    ``Fx`` (float32 or float64): for each parent p, over its children g,

        panel[p][f, h] -= sum_g U_g[idxf[p, g, f], idxf[p, g, h]]
                          (f < Npt + Mbt, h < Npt)
        slot[p] += the same sum over the below rows, lower triangle only

    U_g the child's (Mbc, Mbc) update slab at ``coff[p, g]``, a frame row
    with ``idxf`` = Mbc one the child lacks (it adds 0), ``pdst[p]`` and
    ``udst[p]`` the parent's panel and slot offsets (-1: skipped).  With
    ``bf16`` each placed value is rounded to bfloat16 before the sum.
    ``idxf`` is (Pq, G, Npt + Mbt) int32, ``coff`` (Pq, G), ``pdst`` and
    ``udst`` (Pq,) int64; ``udst`` is None when Mbt is 0.  The offsets are
    the plan's and are not checked.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel ``csrc/pf_extend_add.cu`` or
    raises."""
    if Fx.device.type == "cpu":
        return extend_add_plain(Fx, idxf, coff, pdst, udst, Mbc, Npt, Mbt,
                                bf16)
    if Fx.device.type != "cuda":
        raise ValueError(f"extend_add: unsupported device {Fx.device}")
    if Fx.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"extend_add: dtype {Fx.dtype} (float32/float64)")
    if idxf.dim() != 3 or idxf.shape[2] != Npt + Mbt \
            or idxf.dtype != torch.int32:
        raise ValueError(f"extend_add: idxf must be (Pq, G, {Npt + Mbt}) "
                         f"int32, got {tuple(idxf.shape)} {idxf.dtype}")
    Pq, G, _ = idxf.shape
    want = [(coff, (Pq, G)), (pdst, (Pq,))] + ([(udst, (Pq,))] if Mbt
                                               else [])
    for t, shape in want:
        if tuple(t.shape) != shape or t.dtype != torch.int64:
            raise ValueError(f"extend_add: an offset array must be {shape} "
                             f"int64, got {tuple(t.shape)} {t.dtype}")
    for t in [Fx, idxf] + [t for t, _ in want]:
        if t.device != Fx.device or not t.is_contiguous():
            raise ValueError("extend_add: operands must be contiguous, on "
                             "the buffer's device")
    if Fx.dim() != 1:
        raise ValueError("extend_add: the buffer must be flat")
    cuda_build.launch("sstpu_pf_extend_add_f32" if Fx.dtype == torch.float32
                      else "sstpu_pf_extend_add_f64", Fx, Fx.data_ptr(),
                      idxf.data_ptr(), coff.data_ptr(), pdst.data_ptr(),
                      udst.data_ptr() if Mbt else 0, Pq, G, Mbc, Npt, Mbt,
                      int(bool(bf16)))
    extend_add.launches += 1


# Launches of the kernel: one for each call above, and for each replay of a
# captured device program the number its capture recorded (a replay makes
# no Python call; utils/programs.py adds them)
extend_add.launches = 0


def _pair_step(Mbc, G, Pq, Npt, Mbt, pc, uc, spanq, bf16=False):
    """Pair-grouped projection: each parent's children (padded to pow2 G)
    placed into its frame by one ``extend_add``, in the scope
    ``Qextend`` + f"{Mbc}g{G}".  The plan's gather and destination modes
    (``spanq``, ``pc``, ``uc``) serve the reference's XLA forms: the
    kernel reads every child and parent by offset.

    bf16: the reference's bfloat16 placement -- the placed update entries
    rounded to bfloat16, then summed over the children in the factor's
    dtype (its placement weights are exact 0/1 one-hots)."""
    name = f"Qextend{Mbc}g{G}"

    def step(Fx, pos, ops):
        with _scope(name):
            extend_add(Fx, ops["idxf"][pos], ops["coff"][pos],
                       ops["pdst"][pos], ops["udst"][pos] if Mbt else None,
                       Mbc, Npt, Mbt, bf16)
    return step


def _pf_steps(class_ops, meta, syrk_bf16=False, trsm_inv=True):
    fops, pops, qops = class_ops
    fmeta, pmeta, qmeta = meta
    steps = [(_factor_step(*m, syrk_bf16, trsm_inv), o)
             for o, m in zip(fops, fmeta)]
    steps += [(_proj_step(*m), o) for o, m in zip(pops, pmeta)]
    steps += [(_pair_step(*m, syrk_bf16), o) for o, m in zip(qops, qmeta)]
    return steps


def pf_program(pfp: PFPlan, dtype, syrk_bf16=False, trsm_inv=True,
               device=None) -> DeviceProgram:
    """The pass-forward refactorization as one device program, cached on
    the plan per (dtype, syrk_bf16, trsm_inv, device): the reference's
    compiled pf program (suitesparse_tpu/cholesky/pf.py:1052-1094).  Its
    body is the A-assembly into a zero buffer, then the instruction stream
    in order; it takes the (nnz,) values and returns the flat (pfp.buf,)
    buffer."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def make():
        a_src, a_dst = _device_amaps(pfp._cache, pfp.plan.ss, dev)
        steps = _pf_steps(pfp.arrays(dt, dev), pfp.meta, syrk_bf16, trsm_inv)
        stream = [steps[cid] + (pos,) for cid, pos
                  in zip(pfp.instr_cls.tolist(), pfp.instr_pos.tolist())]

        def body(vals):
            with _scope("Assemble"):
                Fx = assemble(vals, a_src, a_dst, pfp.buf)
            for step, cops, pos in stream:
                step(Fx, pos, cops)
            return Fx
        return body

    return cached_program(pfp._cache, ("pf", dt, bool(syrk_bf16),
                                       bool(trsm_inv), dev), make, dev,
                          counters=(block_chol, extend_add))


def pf_numeric(vals, pfp: PFPlan, dtype, syrk_bf16=False, device=None,
               trsm_inv=True):
    """The full numeric factorization with pass-forward extend-add, run as
    ``pf_program``: a replay of its graph on the card, the body on the
    CPU.  Returns the flat (pfp.buf,) buffer on ``device`` (the card unless
    "cpu" is asked for), never shared with a later call's.  syrk_bf16: the
    SYRK updates and the pair placements from bfloat16 inputs, summed in
    ``dtype``.  trsm_inv (Common.cholesky.trsm_inv): False factors every
    panel class by torch.linalg's Cholesky and triangular solve instead of
    panel_factor (block_chol and the explicit inverse): the reference's
    XLA path with SSTPU_TRSM_INV=0."""
    prog = pf_program(pfp, dtype, syrk_bf16, trsm_inv, device)
    return prog(torch.as_tensor(vals, dtype=torch_dtype(dtype),
                                device=prog.device))
