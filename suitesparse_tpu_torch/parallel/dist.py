"""Distributed supernodal elimination over torch.distributed ranks.

Counterpart of suitesparse_tpu/parallel/dist.py.  The host plan
(``build_dist_plan``: proportional subtree mapping, the owner-contiguous
relayout, wave ownership, the root peel, the merged DAG schedule and the
top-front fan-out list) is the reference's, copied, so every plan array is
identical.  The reference runs one ``shard_map`` program over a mesh of
devices; here each rank is one process of a ``torch.distributed`` group and
runs the same program on its own device, the compute between two
collectives as device programs (``_rank_programs``: CUDA graphs replayed
on the card, utils/programs.py) and the collectives eagerly between them:

1. **Owner-contiguous layout**: panels are laid out
   ``[rank0 | rank1 | ... | top | trash | scratch]``; each rank holds ONLY
   ``[own region | top | trash]`` (``lbuf`` elements).  Global offsets are
   rebased to local ones on the host, once per (plan, rank, device, dtype):
   ``x - d*Bloc`` below the top, ``x - (ndev-1)*Bloc`` above it.
2. **Phase 1, no communication**: the rank runs its own waves in the
   static slot order (``seq_cls``/``seq_pos``); the dead slots that pad the
   SPMD sequence of the reference are skipped on the host.
3. **Phase boundary, exactly one collective**: an all-reduce of the
   top-region contributions.
4. **Phase 2**: the top waves run replicated, large top fronts
   (``top_fan``) and the peeled root run column-block-cyclic: one
   broadcast from the owner per block column, one all-reduce to merge.

The solve is distributed too (``DistFactor.solve``): per-rank subtree
solves, one all-reduce of the x delta, the replicated top solves, the
backward subtree solves and a second all-reduce: two per solve.

The caller creates the process group and chooses its backend; nothing here
creates a group or switches backends.  Every collective goes through a
``Mesh``, which counts calls and bytes per phase.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..cholesky.super_numeric import (_a_sorted_maps, _index, _panels,
                                      _seg_lengths, cholesky_or_nan,
                                      segment_sum, syrk)
from ..core.sparse import INDEX
from ..utils.device import (default_dtype, numpy_dtype, resolve_device,
                            torch_dtype)
from ..utils.programs import Binding, DeviceProgram
from .block_cyclic import cyclic_potrf


# ---------------------------------------------------------------------------
# The mesh: a process group, this rank, its device, and collective counts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """One rank's view of the distributed run: the process group (None is
    the default group), this rank, the number of ranks and the device its
    tensors live on.  ``counts[(phase, op)]`` and ``nbytes[phase]`` record
    every collective issued through it; bytes are what a ring algorithm
    moves per rank: 2(P-1)/P of the tensor for an all-reduce, the tensor
    for a broadcast, (P-1) tensors for an all-gather."""

    group: object
    rank: int
    ndev: int
    device: torch.device
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    nbytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def reset_counts(self) -> None:
        self.counts.clear()
        self.nbytes.clear()

    def _log(self, phase, op, nbytes):
        self.counts[(phase, op)] += 1
        self.nbytes[phase] += int(nbytes)

    def all_reduce(self, t: torch.Tensor, phase: str,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of ``t`` (contiguous); returns ``t``."""
        P = self.ndev
        self._log(phase, "all_reduce",
                  t.numel() * 2 * (P - 1) // max(P, 1) * t.element_size())
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int,
                  phase: str) -> torch.Tensor:
        """In-place broadcast of ``t`` from group rank ``src``."""
        self._log(phase, "broadcast", t.numel() * t.element_size())
        g = (src if self.group is None
             else dist.get_global_rank(self.group, src))
        dist.broadcast(t, src=g, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, phase: str) -> list:
        """Every rank's ``t`` (equal shapes), in rank order."""
        self._log(phase, "all_gather",
                  t.numel() * (self.ndev - 1) * t.element_size())
        out = [torch.empty_like(t) for _ in range(self.ndev)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out


def make_mesh(group=None, device=None) -> Mesh:
    """This rank's Mesh over ``group`` (None: the default group, which the
    caller initialized with the backend of its choice).

    device: None means this rank's card, ``cuda:LOCAL_RANK % count``
    (the group rank when LOCAL_RANK is unset), and raises without one;
    "cpu" runs the plain PyTorch path."""
    dev = resolve_device(device)            # None: raises without a card
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed process group "
                           "is initialized")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank(group)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return Mesh(group=group, rank=dist.get_rank(group),
                ndev=dist.get_world_size(group), device=dev)


def make_global_mesh(device=None) -> Mesh:
    """The Mesh over every rank of the job (the default group), on one
    node or many: the program's only cross-rank traffic is the Mesh's
    collectives, whatever the group spans."""
    return make_mesh(None, device)


def shard_inputs(mesh: Mesh, host_array: np.ndarray) -> np.ndarray:
    """This rank's row of a per-rank plan array (ndev, ...)."""
    host_array = np.asarray(host_array)
    if host_array.shape[0] != mesh.ndev:
        raise ValueError(f"per-rank array has {host_array.shape[0]} rows "
                         f"for {mesh.ndev} ranks")
    return host_array[mesh.rank]


# ---------------------------------------------------------------------------
# Host planning (the reference's, copied)
# ---------------------------------------------------------------------------

def _subtree_owners(ss, ndev: int, oversub: int = 4) -> np.ndarray:
    """Proportional mapping: owner[s] in [0, ndev) for subtree supernodes,
    -1 for the shared top phase.  Subtrees are etree-closed, so phase-1
    extend-adds never cross ranks."""
    nsuper = ss.nsuper
    parent = np.asarray(ss.sn_parent)
    # per-supernode flop proxy: panel ms^2 * ns (SYRK+POTRF+TRSM class)
    w = np.empty(nsuper)
    size = np.ones(nsuper, dtype=np.int64)
    for s in range(nsuper):
        ms, ns = ss.panel_shape(s)
        w[s] = float(ms) * ms * ns + 1.0
    subw = w.copy()
    children: list[list[int]] = [[] for _ in range(nsuper)]
    for s in range(nsuper):        # postordered: parent > child
        p = int(parent[s])
        if p >= 0:
            subw[p] += subw[s]
            size[p] += size[s]
            children[p].append(s)
    heap = [(-subw[s], s) for s in range(nsuper) if parent[s] < 0]
    heapq.heapify(heap)
    target = max(ndev * oversub, ndev)
    stuck: list[tuple[float, int]] = []
    while heap and (len(heap) + len(stuck)) < target:
        negw, r = heapq.heappop(heap)
        if not children[r]:
            stuck.append((negw, r))   # leaf supernode: cannot split further
            continue
        for c in children[r]:         # r itself moves to the top phase
            heapq.heappush(heap, (-subw[c], c))
    roots = [s for _, s in heap] + [s for _, s in stuck]
    # LPT assignment by subtree weight
    loads = [(0.0, c) for c in range(ndev)]
    heapq.heapify(loads)
    owner = np.full(nsuper, -1, dtype=np.int64)
    for r in sorted(roots, key=lambda s: -subw[s]):
        load, c = heapq.heappop(loads)
        owner[r - size[r] + 1: r + 1] = c     # postorder: contiguous subtree
        heapq.heappush(loads, (load + subw[r], c))
    return owner


def _assign_region(levels, shapes, mine, pad, wave_w, panel_off, panel_Np,
                   panel_Mp, base0: int):
    """Owner-contiguous layout for the supernodes in `mine` (bool mask),
    mirroring supernodal._assign_layout's bucket/wave rounding."""
    base = base0
    level_buckets = []
    for level in levels:
        groups: dict[tuple[int, int], list[int]] = {}
        for s in np.asarray(level).tolist():
            if not mine[s]:
                continue
            ms, ns = shapes[s]
            mb = ms - ns
            key = (pad(ns), pad(mb) if mb else 0)
            groups.setdefault(key, []).append(s)
        buckets = []
        for (Np, Mb), sids in sorted(groups.items()):
            bbase = base
            for s in sids:
                panel_off[s] = base
                panel_Np[s] = Np
                panel_Mp[s] = Np + Mb
                base += (Np + Mb) * Np
            W = wave_w[(Np, Mb)]
            nwave = -(-len(sids) // W)
            base = bbase + nwave * W * (Np + Mb) * Np
            buckets.append((Np, Mb, bbase, np.array(sids, dtype=INDEX), W))
        level_buckets.append(buckets)
    return level_buckets, base


@dataclasses.dataclass
class DistPlan:
    """Host-side distributed plan: re-laid-out symbolic + wave program
    pieces partitioned by owner."""

    ss: object                 # SuperSymbolic with the owner-contiguous layout
    plan: object               # global NumericPlan (solve / reference)
    wp: object                 # global WavePlan
    sym: object
    owner: np.ndarray          # per supernode
    ndev: int
    Bloc: int                  # per-rank region length
    top_base: int
    Btop: int                  # top-region length
    buf: int                   # GLOBAL buffer length (wp.buf + nop scratch)
    lbuf: int                  # per-rank LOCAL buffer: own + top + trash
    instr_cls: np.ndarray      # (ndev, T1) per-rank phase-1 instructions
    instr_pos: np.ndarray
    seq_cls: tuple             # (Tp,) static phase-1 class sequence
    seq_pos: np.ndarray        # (ndev, Tp) per-rank pos (dead-wave pads)
    top_cls: np.ndarray        # (T2,) shared top instructions (root peeled)
    top_pos: np.ndarray
    top_fan: tuple             # [(top index, nb)] fronts run via fanout
    top_solve_cls: np.ndarray  # top waves incl. the peeled root (solve)
    top_solve_pos: np.ndarray
    a_dst_local: np.ndarray    # (ndev, nnz) per-rank local A targets
    nop_cls: int
    root: Optional[tuple]      # (base, Np, nb, padeye, colmask): 2D root
    comm: dict
    # per-(rank, device, dtype) rebased operands, built on first use
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)


def build_dist_plan(A, ndev: int, common=None, oversub: int = 4,
                    root_2d_min: int = 256, root_2d_nb: int = 128,
                    seq: str = "merge", model_rate: float = None,
                    model_dispatch_s: float = None):
    """Analyze + subtree mapping + owner-contiguous relayout + wave split.
    Pure host preprocessing, once per (pattern, ndev).

    seq: "merge" (the DAG-ready merged slot schedule) or "level" (the
    per-(level, class) barrier schedule); anything else raises.
    model_rate (flop/s) and model_dispatch_s (s per issued wave): the
    constants of the timeline model behind ``dist_model_speedup_disp``,
    which is reported only when both are given (they are a device's
    measured rates; no default stands for every device)."""
    if seq not in ("merge", "level"):
        raise ValueError(f"seq must be 'merge' or 'level', not {seq!r}")
    from ..cholesky import analyze, super_symbolic
    from ..cholesky.super_numeric import build_plan
    from ..cholesky.supernodal import (_pad_dim, _pad_dim_coarse, _pick_wave)
    from ..cholesky.symbolic import _force_upper
    from ..core.common import default_common

    cm = common or default_common()
    cm.cholesky.supernodal = "supernodal"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    owner = _subtree_owners(ss, ndev, oversub)

    # --- owner-contiguous relayout ---------------------------------------
    pad = (_pad_dim_coarse if cm.cholesky.shape_ladder == "coarse"
           else _pad_dim)
    nsuper = ss.nsuper
    shapes = [ss.panel_shape(s) for s in range(nsuper)]
    # shared wave sizes per shape class, over per-(owner, level) group sizes
    class_bs: dict[tuple[int, int], list[int]] = {}
    for o in list(range(ndev)) + [-1]:
        for level in ss.levels:
            groups: dict[tuple[int, int], int] = {}
            for s in np.asarray(level).tolist():
                if owner[s] != o:
                    continue
                ms, ns = shapes[s]
                mb = ms - ns
                key = (pad(ns), pad(mb) if mb else 0)
                groups[key] = groups.get(key, 0) + 1
            for key, cnt in groups.items():
                class_bs.setdefault(key, []).append(cnt)
    wave_w = {key: _pick_wave(key[0], key[1], bs)
              for key, bs in class_bs.items()}

    panel_off = np.zeros(nsuper, dtype=INDEX)
    panel_Np = np.zeros(nsuper, dtype=INDEX)
    panel_Mp = np.zeros(nsuper, dtype=INDEX)
    chip_lb = []
    sizes = []
    for c in range(ndev):
        lb, end = _assign_region(ss.levels, shapes, owner == c, pad, wave_w,
                                 panel_off, panel_Np, panel_Mp, 0)
        chip_lb.append(lb)
        sizes.append(end)
    Bloc = max(sizes) if sizes else 0
    for c in range(ndev):          # shift rank regions to c * Bloc
        for s in np.nonzero(owner == c)[0]:
            panel_off[s] += c * Bloc
        chip_lb[c] = [[(Np, Mb, b + c * Bloc, sids, W)
                       for (Np, Mb, b, sids, W) in lv] for lv in chip_lb[c]]
    top_base = ndev * Bloc
    # top-phase layout: big fronts get W=1 so each is its own wave and the
    # column-block-cyclic fanout (_front_fanout) can distribute it
    wave_w_top = {k: (1 if (ndev > 1 and k[0] >= root_2d_min) else w)
                  for k, w in wave_w.items()}
    top_lb, total = _assign_region(ss.levels, shapes, owner == -1, pad,
                                   wave_w_top, panel_off, panel_Np,
                                   panel_Mp, top_base)
    Btop = total - top_base

    # global bucket schedule: per level, ranks then top
    global_lb = []
    for li in range(len(ss.levels)):
        lv = []
        for c in range(ndev):
            lv.extend(chip_lb[c][li])
        lv.extend(top_lb[li])
        global_lb.append(lv)

    ss2 = dataclasses.replace(ss, panel_off=panel_off, panel_Np=panel_Np,
                              panel_Mp=panel_Mp, total=int(total),
                              level_buckets=global_lb, lnz_dense=int(total),
                              wave_w=wave_w, a_scatter_dst=None)
    # A-assembly map in the new coordinates (same construction as
    # super_symbolic's tail)
    n = ss.n
    U = _force_upper(A) if A.stype == 0 else (
        A if A.stype > 0 else A.transpose())
    PL = U.symperm(sym.perm, values=False).transpose()
    PL.sort_indices()
    cols = np.repeat(np.arange(n, dtype=INDEX), np.diff(PL.indptr))
    rows = PL.indices
    s_of = ss2.col_to_super[cols]
    a_dst = np.empty(PL.nnz, dtype=INDEX)
    rows_list = [ss2.rows_of(s) for s in range(nsuper)]
    for s in range(nsuper):
        mask = s_of == s
        if not mask.any():
            continue
        local = np.searchsorted(rows_list[s], rows[mask])
        a_dst[mask] = ss2.flat_pos(s, local, cols[mask] - int(ss2.super[s]))
    ss2.a_scatter_dst = a_dst
    ss2.a_scatter_src = np.arange(PL.nnz, dtype=INDEX)

    plan = build_plan(ss2)
    wp = plan.wave_plan()

    # --- wave ownership (mirror build_wave_plan's enumeration order) -----
    wave_owner = []
    wave_level = []
    for li, lv in enumerate(plan.levels):
        for b in lv:
            nw = -(-len(b.sids) // b.W)
            wave_owner.extend([int(owner[int(b.sids[0])])] * nw)
            wave_level.extend([li] * nw)
    wave_owner = np.asarray(wave_owner)
    wave_level = np.asarray(wave_level)
    assert len(wave_owner) == len(wp.instr_cls), "wave enumeration mismatch"

    # lone large root front -> peel for the block-cyclic POTRF
    root = None
    top_keep = np.ones(len(wp.instr_cls), dtype=bool)
    last_lv = plan.levels[-1] if plan.levels else []
    if (ndev > 1 and len(last_lv) == 1 and len(last_lv[0].sids) == 1
            and last_lv[0].Mb == 0 and last_lv[0].Np >= root_2d_min
            and last_lv[0].W == 1
            and owner[int(last_lv[0].sids[0])] == -1):
        b = last_lv[0]
        nb = root_2d_nb
        while b.Np % nb:
            nb //= 2
        root = (int(b.base), int(b.Np), int(nb),
                b.padeye[0].astype(np.float64),
                b.colmask[0].astype(np.float64))
        top_keep[len(wp.instr_cls) - 1] = False   # root = last wave

    # dead waves: every class gets one appended all-masked wave at a shared
    # scratch region past wp.buf (the reference's SPMD program pads any
    # class with it; the port skips dead slots but keeps the plan's layout)
    metas = wp.meta
    nop_cls = int(np.argmin([(Np + Mb) * Np * W
                             for (Np, Mb, W, *_r) in metas]))
    scratch = max(((Np + Mb) * Np * W) for (Np, Mb, W, *_r) in metas)
    buf = wp.buf + scratch

    sel1 = wave_owner >= 0
    t1 = np.array([int((sel1 & (wave_owner == c)).sum())
                   for c in range(ndev)])
    T1 = int(t1.max()) if len(t1) else 0
    instr_cls = np.full((ndev, max(T1, 1)), nop_cls, dtype=np.int32)
    # nop pos = appended row index (class stack length)
    nop_pos = len(wp.classes[nop_cls].base)
    instr_pos = np.full((ndev, max(T1, 1)), nop_pos, dtype=np.int32)
    for c in range(ndev):
        idx = np.nonzero(wave_owner == c)[0]
        instr_cls[c, :len(idx)] = wp.instr_cls[idx]
        instr_pos[c, :len(idx)] = wp.instr_pos[idx]

    # --- canonical static class sequence ---------------------------------
    # Waves within one elimination level are data-independent, so each
    # rank's level-li waves can be reordered canonically by class and
    # padded with dead waves: the class sequence becomes static, shared by
    # every rank.  The phase-1 subtree streams need no communication
    # (subtrees are etree-closed), so a shared slot only needs a common
    # shape CLASS, not a common level: each rank only has to respect its
    # OWN wave dependencies.  seq="merge" schedules each rank's waves by
    # exact DAG readiness and emits each slot for the class runnable by
    # the most ranks; seq="level" is the rigid per-(level, class) barrier
    # form, which pads every class to the max rank count at every level.
    seq_cls = []
    seq_pos_l: list[list[int]] = [[] for _ in range(ndev)]
    dead_pos = [len(c.base) for c in wp.classes]
    if seq == "merge" and ndev > 1:
        # Exact wave-DAG readiness.  A wave's extend-add scatters into
        # ANCESTOR panels only, and every ancestor chain crosses the
        # immediate parent -- so parent edges (wave(s) -> wave(sn_parent(s))
        # within one rank) transitively enforce "all descendants' scatters
        # land before an ancestor's factor wave reads its panel".  Any
        # per-rank topological order of this DAG is a valid schedule.
        import bisect
        wave_sids: list[np.ndarray] = []   # mirrors the wave enumeration
        for lv in plan.levels:
            for b in lv:
                for w0 in range(0, len(b.sids), b.W):
                    wave_sids.append(np.asarray(b.sids[w0:w0 + b.W]))
        nwaves = len(wave_sids)
        assert nwaves == len(wave_owner)
        wave_of = np.full(nsuper, -1, dtype=np.int64)
        for wi, sd in enumerate(wave_sids):
            wave_of[sd] = wi
        parent_sn = np.asarray(ss.sn_parent)
        npred = np.zeros(nwaves, dtype=np.int64)
        succs: list[list[int]] = [[] for _ in range(nwaves)]
        for s in range(nsuper):
            if owner[s] < 0:
                continue
            p = int(parent_sn[s])
            if p >= 0 and owner[p] == owner[s]:
                wu, wv = int(wave_of[s]), int(wave_of[p])
                if wu != wv:
                    succs[wu].append(wv)
                    npred[wv] += 1
        npred0 = npred
        preds: list[list[int]] = [[] for _ in range(nwaves)]
        for wu in range(nwaves):
            for wv in succs[wu]:
                preds[wv].append(wu)

        def _greedy(tiebreak):
            """One list-scheduling pass; returns [(cid, {rank: wave})].
            tiebreak orders equally-voted classes (determinism)."""
            npred = npred0.copy()
            ready: list[dict[int, list]] = [{} for _ in range(ndev)]

            def _push(wi):
                c = int(wave_owner[wi])
                lst = ready[c].setdefault(int(wp.instr_cls[wi]), [])
                bisect.insort(lst, (int(wave_level[wi]), int(wi)))

            for wi in range(nwaves):
                if wave_owner[wi] >= 0 and npred[wi] == 0:
                    _push(wi)
            sched = []
            while any(ready[c] for c in range(ndev)):
                votes: dict[int, list[int]] = {}
                for c in range(ndev):
                    for cid, lst in ready[c].items():
                        v = votes.setdefault(cid, [0, 0])
                        v[0] += 1
                        v[1] += len(lst)
                cid = max(votes,
                          key=lambda k: (votes[k][0], tiebreak(votes[k]), -k))
                row: dict[int, int] = {}
                for c in range(ndev):
                    lst = ready[c].get(cid)
                    if lst:
                        _lv, wi = lst.pop(0)
                        if not lst:
                            del ready[c][cid]
                        row[c] = wi
                        for wv in succs[wi]:
                            npred[wv] -= 1
                            if npred[wv] == 0:
                                _push(wv)
                sched.append((int(cid), row))
            return sched

        # two deterministic tie-breaks (most-ready-first vs rare-first),
        # keep the shorter schedule
        sched = min((_greedy(lambda v: v[1]), _greedy(lambda v: -v[1])),
                    key=len)
        # compaction: sweep the slots from the last to the first, pull each
        # wave into the earliest same-class slot where its rank is idle and
        # every predecessor is already behind it; drop slots that empty out.
        # Only the predecessor bound needs checking, also for a wave met a
        # second time (moved earlier into a slot the sweep has not reached
        # yet): the greedy pass puts every successor at a later slot than
        # the wave's original one, a successor is swept while the wave still
        # sits there (moves only go to earlier slots, and the sweep reaches
        # the successor's slots first), so its own move keeps it behind
        # that slot, and the wave itself only moves further forward.
        slot_of = {}
        for t, (cid, row) in enumerate(sched):
            for c, wi in row.items():
                slot_of[wi] = t
        for t in range(len(sched) - 1, -1, -1):
            cid, row = sched[t]
            for c in sorted(row):
                wi = row[c]
                lo = max((slot_of[p] + 1 for p in preds[wi]), default=0)
                for t2 in range(lo, t):
                    cid2, row2 = sched[t2]
                    if cid2 == cid and c not in row2:
                        row2[c] = wi
                        del row[c]
                        slot_of[wi] = t2
                        break
        sched = [(cid, row) for cid, row in sched if row]
        for cid, row in sched:
            seq_cls.append(cid)
            for c in range(ndev):
                seq_pos_l[c].append(
                    int(wp.instr_pos[row[c]]) if c in row else dead_pos[cid])
    else:
        for li in range(len(plan.levels)):
            in_lv = (wave_level == li) & sel1
            if not in_lv.any():
                continue
            for cid in sorted(set(wp.instr_cls[in_lv].tolist())):
                per_chip = [np.nonzero(in_lv & (wave_owner == c)
                                       & (wp.instr_cls == cid))[0]
                            for c in range(ndev)]
                m = max(len(ix) for ix in per_chip)
                for t in range(m):
                    seq_cls.append(int(cid))
                    for c in range(ndev):
                        ix = per_chip[c]
                        seq_pos_l[c].append(
                            int(wp.instr_pos[ix[t]]) if t < len(ix)
                            else dead_pos[cid])
    Tp = max(len(seq_cls), 1)
    seq_pos = np.full((ndev, Tp), 0, dtype=np.int32)
    for c in range(ndev):
        seq_pos[c, :len(seq_cls)] = seq_pos_l[c]
    seq_cls = tuple(seq_cls)
    topidx = np.nonzero((wave_owner < 0) & top_keep)[0]
    top_cls = wp.instr_cls[topidx].astype(np.int32)
    top_pos = wp.instr_pos[topidx].astype(np.int32)
    # large W==1 top fronts get the column-block-cyclic fanout instead of
    # replicated execution (same threshold family as the root peel)
    top_fan = []
    if ndev > 1:
        for t, (tc, tp) in enumerate(zip(top_cls, top_pos)):
            c = wp.classes[int(tc)]
            if c.W == 1 and c.Np >= root_2d_min and c.Np % 8 == 0:
                nbf = root_2d_nb
                while c.Np % nbf:
                    nbf //= 2
                top_fan.append((t, int(nbf)))
    top_fan = tuple(top_fan)
    # the solve needs EVERY top wave including a peeled 2D root (the root
    # panel is a plain factored panel by solve time)
    topidx_s = np.nonzero(wave_owner < 0)[0]
    top_solve_cls = wp.instr_cls[topidx_s].astype(np.int32)
    top_solve_pos = wp.instr_pos[topidx_s].astype(np.int32)

    # per-rank LOCAL buffer [own | top | trash/scratch]: every global
    # offset >= top_base shifts down by (ndev-1)*Bloc, own-region offsets
    # by c*Bloc -- so lbuf is simply buf - (ndev-1)*Bloc
    lbuf = int(buf) - (ndev - 1) * int(Bloc)
    # per-rank A-assembly targets in local coordinates; entries outside
    # [own | top] point at lbuf, past the buffer, and are dropped
    a_src, a_dst = _a_sorted_maps(ss2)
    a_dst = np.asarray(a_dst)
    adl = np.empty((ndev, len(a_dst)), dtype=np.int64)
    in_top = a_dst >= top_base
    for c in range(ndev):
        own = (a_dst >= c * Bloc) & (a_dst < (c + 1) * Bloc)
        adl[c] = np.where(own, a_dst - c * Bloc,
                          np.where(in_top, a_dst - (ndev - 1) * Bloc, lbuf))

    # element counts, scaled to bytes by the dtype factorized with
    # (distributed_factorize).  Flop accounting for the scaling model: on
    # separate devices the factor wall is ~ max per-rank subtree work +
    # the replicated top + the fanned fronts at 1/ndev.
    wfl = np.empty(nsuper)
    fanned = np.zeros(nsuper, dtype=bool)
    for s_ in range(nsuper):
        ms_, ns_ = shapes[s_]
        wfl[s_] = float(ms_) * ms_ * ns_
        fanned[s_] = (owner[s_] == -1 and ndev > 1
                      and pad(ns_) >= root_2d_min)
    chip_fl = np.array([wfl[owner == c].sum() for c in range(ndev)])
    top_repl_fl = float(wfl[(owner == -1) & ~fanned].sum())
    top_fan_fl = float(wfl[fanned].sum())
    tot_fl = float(wfl.sum())
    _real_waves = int(sel1.sum())
    _pad_slots = int(len(seq_cls))
    _top_w = int(len(topidx))
    comm = dict(
        dist_chip_flops_max=float(chip_fl.max()) if ndev else 0.0,
        dist_chip_flops_mean=float(chip_fl.mean()) if ndev else 0.0,
        dist_top_flops=top_repl_fl + top_fan_fl,
        dist_top_fanned_flops=top_fan_fl,
        dist_model_speedup=(
            tot_fl / max(float(chip_fl.max()) + top_repl_fl
                         + top_fan_fl / max(ndev, 1), 1.0)))
    if model_rate is not None and model_dispatch_s is not None:
        # timeline model per rank: t(nd) = work_fl(nd) / R + n_slots(nd) *
        # c_instr, with R the single-device factor rate and c_instr the
        # cost of issuing one wave; pad slots enter at full c_instr
        _R, _c = float(model_rate), float(model_dispatch_s)
        _t1 = tot_fl / _R + (_real_waves + _top_w) * _c
        _tn = (float(chip_fl.max()) + top_repl_fl
               + top_fan_fl / max(ndev, 1)) / _R + (_pad_slots + _top_w) * _c
        comm["dist_model_speedup_disp"] = _t1 / max(_tn, 1e-12)
    comm.update(
        dist_pad_ratio=(_pad_slots / max(_real_waves / max(ndev, 1), 1.0)
                        if ndev > 1 else 1.0),
        dist_psum_elems=int(Btop) * 2 * (ndev - 1) // max(ndev, 1),
        dist_root_elems=(root[1] * root[1] + root[1] * root[2]
                         * (root[1] // root[2])) if root else 0,
        dist_solve_psum_elems=2 * n * 2 * (ndev - 1) // max(ndev, 1),
        dist_phase1_waves=int(sel1.sum()),
        dist_phase1_padded_waves=int(len(seq_cls)),
        dist_top_waves=int(len(topidx)),
        dist_ndev=ndev, dist_Bloc=int(Bloc), dist_Btop=int(Btop),
        dist_lbuf=int(lbuf))
    cm.info.update(comm)
    return DistPlan(ss=ss2, plan=plan, wp=wp, sym=sym, owner=owner,
                    ndev=ndev, Bloc=int(Bloc), top_base=int(top_base),
                    Btop=int(Btop), buf=int(buf), lbuf=lbuf,
                    instr_cls=instr_cls,
                    instr_pos=instr_pos, seq_cls=seq_cls, seq_pos=seq_pos,
                    top_cls=top_cls, top_pos=top_pos, top_fan=top_fan,
                    top_solve_cls=top_solve_cls, top_solve_pos=top_solve_pos,
                    a_dst_local=adl, nop_cls=nop_cls, root=root, comm=comm)


# ---------------------------------------------------------------------------
# Per-rank operands (the reference's _nop_extended_ops + _loc, on the host)
# ---------------------------------------------------------------------------

def _rebase(x, d: int, dp: DistPlan) -> np.ndarray:
    """Global buffer offsets -> rank d's local offsets (module docstring
    item 1): own region ``x - d*Bloc``, top and trash ``x - (ndev-1)*Bloc``."""
    x = np.asarray(x, dtype=np.int64)
    return np.where(x < dp.top_base, x - d * dp.Bloc,
                    x - (dp.ndev - 1) * dp.Bloc)


@dataclasses.dataclass
class _RankProgram:
    """What one rank runs: its wave operands (only the waves it runs, rows
    renumbered), the schedules as (class, row) pairs, and its A map."""

    fac: tuple                 # per class: factor operands (rebased)
    sol: tuple                 # per class: solve operands (rebased)
    phase1: list               # [(cid, row)] own waves, slot order
    top: list                  # [(t, cid, row)] top waves (root peeled)
    top_solve: list            # [(cid, row)] top waves incl. the root
    a_src: torch.Tensor        # values -> local buffer, out-of-region
    a_dst: torch.Tensor        # entries dropped on the host


def _rank_program(dp: DistPlan, mesh: Mesh,
                  dtype: torch.dtype) -> _RankProgram:
    rank, dev = mesh.rank, mesh.device
    key = ("prog", rank, dev, dtype)
    got = dp._cache.get(key)
    if got is not None:
        return got
    wp = dp.wp
    dead = [len(c.base) for c in wp.classes]
    p1 = [(int(c), int(p))
          for c, p in zip(dp.seq_cls, shard_inputs(mesh, dp.seq_pos))
          if p != dead[c]]
    top = [(int(c), int(p)) for c, p in zip(dp.top_cls, dp.top_pos)]
    tops = [(int(c), int(p))
            for c, p in zip(dp.top_solve_cls, dp.top_solve_pos)]
    used = [sorted({p for c, p in p1 + tops if c == cid})
            for cid in range(len(wp.classes))]
    row_of = [{p: r for r, p in enumerate(u)} for u in used]
    fac, sol = [], []
    for c, u in zip(wp.classes, used):
        u = np.asarray(u, dtype=np.int64)
        base = _rebase(c.base[u], rank, dp).tolist()
        padeye = torch.as_tensor(c.padeye[u], dtype=dtype, device=dev)
        fac.append(dict(
            base=base, padeye=padeye,
            rowmask=torch.as_tensor(c.rowmask[u], dtype=dtype, device=dev),
            colmask=torch.as_tensor(c.colmask[u], dtype=dtype, device=dev),
            src=_index(c.src[u], dev),
            dst=_index(_rebase(c.dst[u], rank, dp), dev),
            lens=(torch.stack([_seg_lengths(c.ids[i], c.K, dev) for i in u])
                  if c.L and len(u) else None)))
        sol.append(dict(
            base=base, padeye=padeye,
            colidx=_index(c.colidx[u], dev), rowidx=_index(c.rowidx[u], dev),
            c_src=_index(c.c_src[u], dev), c_dst=_index(c.c_dst[u], dev),
            r_src=_index(c.r_src[u], dev), r_dst=_index(c.r_dst[u], dev),
            r_lens=(torch.stack([_seg_lengths(c.r_ids[i], c.RK, dev)
                                 for i in u])
                    if c.RL and len(u) else None)))
    a_src, _ = _a_sorted_maps(dp.ss)
    adl = shard_inputs(mesh, dp.a_dst_local)
    keep = adl < dp.lbuf
    got = _RankProgram(
        fac=tuple(fac), sol=tuple(sol),
        phase1=[(c, row_of[c][p]) for c, p in p1],
        top=[(t, c, row_of[c][p]) for t, (c, p) in enumerate(top)],
        top_solve=[(c, row_of[c][p]) for c, p in tops],
        a_src=_index(np.asarray(a_src)[keep], dev),
        a_dst=_index(adl[keep], dev))
    dp._cache[key] = got
    return got


# ---------------------------------------------------------------------------
# The numeric program, one rank
# ---------------------------------------------------------------------------

def _fanout_potrf(A: torch.Tensor, Np: int, nb: int, mesh: Mesh,
                  phase: str) -> torch.Tensor:
    """Column-block-cyclic right-looking POTRF (block_cyclic.cyclic_potrf)
    of the (Mp, Np) working panel A (symmetric top block over the below
    rows), in place on the block columns this rank owns.  The broadcast
    of each block column's rows >= k*nb from its owner gives the values of
    the reference's psum of a masked panel.  Returns this rank's factored
    columns (zero elsewhere)."""
    Lcols = torch.zeros_like(A)

    def store(k, Lkk, Bk):
        kb = k * nb
        Lcols[kb:kb + nb, kb:kb + nb] = Lkk
        Lcols[kb + nb:, kb:kb + nb] = Bk

    def update(j, k, Bk):
        jc, r0 = j * nb, (k + 1) * nb
        A[r0:, jc:jc + nb] -= Bk @ Bk[jc - r0:jc - r0 + nb].T

    cyclic_potrf(Np // nb, nb, A.shape[0], A, mesh, phase,
                 lambda k: A[k * nb:, k * nb:(k + 1) * nb].contiguous(),
                 store, update)
    return Lcols


def _front_fanout(Lx, dp: DistPlan, mesh: Mesh, cid: int, ops: dict,
                  row: int, nb: int) -> None:
    """One large top front (W == 1) column-block-cyclic across the ranks,
    with its below rows: _fanout_potrf, then one all-reduce merges the
    factored columns and the per-rank partial SYRK U_d = Bm_d Bm_d^T
    (owned columns have disjoint support, so the sum of partials is the
    full update); the extend-add then runs replicated through the wave's
    own maps."""
    c = dp.wp.classes[cid]
    Np, Mb = c.Np, c.Mb
    Mp = Np + Mb
    base = ops["base"][row]
    Pn = Lx[base:base + Mp * Np].view(Mp, Np)
    T = torch.tril(Pn[:Np])
    T = T + torch.tril(T, -1).T + torch.diag(ops["padeye"][row][0])
    A = torch.cat([T, Pn[Np:]], dim=0)              # (Mp, Np) working
    Lcols = _fanout_potrf(A, Np, nb, mesh, "fanout")
    if Mb:
        Bm = Lcols[Np:]
        Ud = Lcols.new_zeros((Mb, Mb))
        for j in range(mesh.rank, Np // nb, mesh.ndev):
            Bj = Bm[:, j * nb:(j + 1) * nb]
            Ud += Bj @ Bj.T
        pack = torch.cat([Lcols.reshape(-1), Ud.reshape(-1)])
    else:
        pack = Lcols.reshape(-1)
    mesh.all_reduce(pack, "fanout")
    Pn.copy_(pack[:Mp * Np].view(Mp, Np) * ops["rowmask"][row][0][:, None]
             * ops["colmask"][row][0][None, :])
    if Mb and c.L:
        seg = segment_sum(pack[Mp * Np:][ops["src"][row]], ops["lens"][row])
        Lx[ops["dst"][row]] -= seg


def _root_fanout(Lx, dp: DistPlan, mesh: Mesh) -> None:
    """The peeled root front (no below rows) column-block-cyclic across
    the ranks; one all-reduce merges the owned columns."""
    base_g, Np, nb, padeye, colmask = dp.root
    base = base_g - (dp.ndev - 1) * dp.Bloc        # top region: constant
    Pn = Lx[base:base + Np * Np].view(Np, Np)
    pe = torch.as_tensor(padeye, dtype=Lx.dtype, device=Lx.device)
    cmk = torch.as_tensor(colmask, dtype=Lx.dtype, device=Lx.device)
    A = Pn + torch.tril(Pn, -1).T + torch.diag(pe)
    L = _fanout_potrf(A, Np, nb, mesh, "root")
    mesh.all_reduce(L, "root")
    Pn.copy_(L * cmk[:, None] * cmk[None, :])


def _mark(dev: torch.device):
    """A point on the device's timeline: on the card a CUDA event recorded
    on the current stream (read once the stream has synchronized), on the
    CPU the host clock.  No host synchronization."""
    if dev.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(dev))
        return e
    return time.perf_counter()


def _seconds(a, b) -> float:
    """Seconds from mark a to mark b (events: both completed)."""
    return b - a if isinstance(a, float) else a.elapsed_time(b) * 1e-3


@dataclasses.dataclass(eq=False)
class _RankSolve:
    """The distributed solve of one rank for k right-hand sides: three
    device programs between its two all-reduces, over static (xrows, k)
    buffers -- x0 the permuted right-hand side, x the working panel, xm
    the panel after the top solves and ``delta`` the all-reduced part."""

    x0: torch.Tensor
    x: torch.Tensor
    xm: torch.Tensor
    delta: torch.Tensor
    forward: DeviceProgram     # b -> the subtree forward solves; delta
    top: DeviceProgram         # x0 + delta -> the top solves; xm
    backward: DeviceProgram    # xm -> the subtree backward solves; delta


@dataclasses.dataclass(eq=False)
class _RankPrograms:
    """One rank's device programs between the collectives, cached on the
    DistPlan per (rank, dtype, device) -- the reference jits the whole
    rank program (suitesparse_tpu/parallel/dist.py:1007) and its solve
    (:1128); gloo's collectives cannot be captured, so the compute between
    them is.  Every program updates the rank's static buffers in place:
    ``Lx`` (the local buffer) and ``init_top`` (the top region as
    assembled); the collectives run eagerly on them between replays.
    ``bound`` names the DistFactor whose values ``Lx`` holds."""

    rp: _RankProgram
    Lx: torch.Tensor
    init_top: torch.Tensor
    phase1: DeviceProgram      # vals -> assembly and the own waves
    phase2: list               # DeviceProgram (a run of replicated top
    #                            waves) or (cid, row, nb) of a fanned front
    solves: dict = dataclasses.field(default_factory=dict)   # k -> _RankSolve
    bound: Binding = dataclasses.field(default_factory=Binding)

    def bind(self, f: "DistFactor") -> None:
        """Put ``f``'s local buffer in ``Lx`` unless it is there."""
        if not self.bound.holds(f, f.Lx):
            self.Lx.copy_(f.Lx)
            self.bound.set(f, f.Lx)


def _rank_programs(dp: DistPlan, mesh: Mesh,
                   dtype: torch.dtype) -> _RankPrograms:
    """This rank's programs (made once per plan, rank, dtype and device):
    phase 1 is the A assembly into the zeroed local buffer and this rank's
    own waves; phase 2 is each maximal run of replicated top waves, with
    the fanned fronts (eager: a broadcast per block column) between them."""
    rank, dev = mesh.rank, mesh.device
    key = ("programs", rank, dev, dtype)
    got = dp._cache.get(key)
    if got is not None:
        return got
    from ..cholesky.wave import _numeric_step
    rp = _rank_program(dp, mesh, dtype)
    steps = [_numeric_step(Np, Mb, W, L, K, False)
             for (Np, Mb, W, L, K, *_r) in dp.wp.meta]
    Bloc, Btop = dp.Bloc, dp.Btop
    Lx = torch.zeros(dp.lbuf, dtype=dtype, device=dev)
    init_top = torch.zeros(Btop, dtype=dtype, device=dev)

    def phase1(vals):
        Lx.zero_()
        Lx[rp.a_dst] = vals[rp.a_src]
        init_top.copy_(Lx[Bloc:Bloc + Btop])
        for cid, row in rp.phase1:
            steps[cid](Lx, row, rp.fac[cid])
        return ()

    def top_run(waves):
        def body():
            for cid, row in waves:
                steps[cid](Lx, row, rp.fac[cid])
            return ()
        return body

    fan = dict(dp.top_fan)
    pieces, run = [], []
    for t, cid, row in rp.top + [(None, None, None)]:
        if t is None or t in fan:
            if run:
                i = len(pieces)
                pieces.append(DeviceProgram(
                    "dist_top", ("dist_top", rank, i, dtype, dev),
                    top_run(run), dev, mutates=(Lx,)))
                run = []
            if t is not None:
                pieces.append((cid, row, fan[t]))
        else:
            run.append((cid, row))
    got = dp._cache[key] = _RankPrograms(
        rp=rp, Lx=Lx, init_top=init_top, phase2=pieces,
        phase1=DeviceProgram("dist_phase1", ("dist_phase1", rank, dtype,
                                             dev), phase1, dev))
    return got


def _factor_local(vals: torch.Tensor, dp: DistPlan, mesh: Mesh,
                  marks: list,
                  run=DeviceProgram.__call__) -> _RankPrograms:
    """The reference's _make_dist_program for this rank: A assembly into
    the local buffer, phase 1, the phase-boundary all-reduce, phase 2 and
    the root, in the rank's programs' buffers (``_rank_programs``).
    ``run(prog, *inputs)`` runs each program (by default its call: a
    replay on the card; the rank job pairs it with its eager body).  Returns the programs; appends five
    ``_mark``s to marks (start, after phase 1, the boundary, phase 2 and
    the root)."""
    dev = vals.device
    rs = _rank_programs(dp, mesh, vals.dtype)
    rs.bound.clear()
    Lx, rp = rs.Lx, rs.rp
    Bloc, Btop = dp.Bloc, dp.Btop
    marks.append(_mark(dev))
    run(rs.phase1, vals)
    marks.append(_mark(dev))
    # phase boundary: ONE all-reduce of the top-region contributions
    if Btop:
        topd = Lx[Bloc:Bloc + Btop] - rs.init_top
        mesh.all_reduce(topd, "boundary")
        Lx[Bloc:Bloc + Btop] = topd + rs.init_top
    marks.append(_mark(dev))
    # phase 2: the shared top, large fronts column-block-cyclic
    for piece in rs.phase2:
        if isinstance(piece, DeviceProgram):
            run(piece)
        else:
            cid, row, nb = piece
            _front_fanout(Lx, dp, mesh, cid, rp.fac[cid], row, nb)
    marks.append(_mark(dev))
    if dp.root is not None:
        _root_fanout(Lx, dp, mesh)
    marks.append(_mark(dev))
    return rs


# ---------------------------------------------------------------------------
# The distributed solve
# ---------------------------------------------------------------------------

def _lsolve_wave(Lx, x, ops, row, Np, Mb, W):
    """The reference's _dist_solve_branch, forward: one wave of L solves
    on local panels (x stays global)."""
    P = _panels(Lx, ops["base"][row], W, Np + Mb, Np)
    C = P[:, :Np, :] + torch.diag_embed(ops["padeye"][row])
    k = x.shape[-1]
    xc = torch.linalg.solve_triangular(C, x[ops["colidx"][row]], upper=False)
    x[ops["c_dst"][row]] = xc.reshape(-1, k)[ops["c_src"][row]]
    if Mb and ops["r_lens"] is not None:
        u = (P[:, Np:, :] @ xc).reshape(-1, k)[ops["r_src"][row]]
        x[ops["r_dst"][row]] -= segment_sum(u, ops["r_lens"][row])


def _ltsolve_wave(Lx, x, ops, row, Np, Mb, W):
    """The backward (L^T) twin of _lsolve_wave."""
    P = _panels(Lx, ops["base"][row], W, Np + Mb, Np)
    C = P[:, :Np, :] + torch.diag_embed(ops["padeye"][row])
    k = x.shape[-1]
    xc = x[ops["colidx"][row]]
    if Mb:
        xc = xc - P[:, Np:, :].transpose(1, 2) @ x[ops["rowidx"][row]]
    xc = torch.linalg.solve_triangular(C.transpose(1, 2), xc, upper=True)
    x[ops["c_dst"][row]] = xc.reshape(-1, k)[ops["c_src"][row]]


@dataclasses.dataclass
class DistFactor:
    """One rank's share of the distributed factor: its local buffer
    ``[own | top | trash]``.  Per-rank memory is O(Bloc + Btop);
    ``gather()`` materializes the full SuperFactor only when asked."""

    dp: DistPlan
    Lx: torch.Tensor           # (lbuf,) local buffer
    mesh: Mesh
    perm: np.ndarray
    minor: int
    dtype: object              # numpy dtype of the factor

    @property
    def own(self) -> torch.Tensor:
        return self.Lx[:self.dp.Bloc]

    @property
    def top(self) -> torch.Tensor:
        return self.Lx[self.dp.Bloc:self.dp.Bloc + self.dp.Btop]

    @property
    def ok(self) -> bool:
        return self.minor == self.dp.plan.n

    def gather(self):
        """The full factor as an ordinary SuperFactor on this rank's
        device.  A collective: every rank must call it."""
        from ..cholesky.super_numeric import SuperFactor
        dp = self.dp
        parts = self.mesh.all_gather(self.own, "gather")
        Lx = self.Lx.new_zeros(dp.buf)
        if dp.ndev:
            Lx[:dp.ndev * dp.Bloc] = torch.cat(parts)
        Lx[dp.top_base:dp.top_base + dp.Btop] = self.top
        return SuperFactor(plan=dp.plan, Lx=Lx, perm=self.perm,
                           minor=self.minor, dtype=self.dtype)

    def solve(self, b, common=None) -> np.ndarray:
        """Distributed solve Ax=b (b on the host, (n,) or (n, k)): panels
        stay with their ranks; two all-reduces of (n x k) x deltas are the
        only communication.  A collective: every rank must call it."""
        from ..core.common import default_common
        cm = common or default_common()
        dp = self.dp
        n = dp.plan.n
        b = np.asarray(b)
        one_d = b.ndim == 1
        bk = b.reshape(n, -1)
        x = _solve_local(self, bk)
        itemsize = int(np.dtype(self.dtype).itemsize)
        cm.info["dist_solve_psum_bytes"] = (
            2 * x.shape[0] * x.shape[1] * 2 * (dp.ndev - 1)
            // max(dp.ndev, 1) * itemsize)
        xh = x[:n].cpu().numpy()
        out = np.empty_like(xh)
        out[self.perm] = xh
        return out.reshape(-1) if one_d else out


def _rank_solve(rs: _RankPrograms, dp: DistPlan, mesh: Mesh,
                k: int) -> _RankSolve:
    """The rank's solve programs for k right-hand sides (made once)."""
    got = rs.solves.get(k)
    if got is not None:
        return got
    rp, Lx = rs.rp, rs.Lx
    meta = dp.wp.meta
    n = dp.plan.n
    dev, dt = Lx.device, Lx.dtype
    x0, x, xm, delta = (torch.zeros((n + dp.wp.xpad, k), dtype=dt,
                                    device=dev) for _ in range(4))

    def forward(b):
        x0.zero_()
        x0[:n] = b
        x.copy_(x0)
        for cid, row in rp.phase1:
            _lsolve_wave(Lx, x, rp.sol[cid], row, *meta[cid][:3])
        delta.copy_(x - x0)
        return ()

    def top():
        x.copy_(x0 + delta)
        for cid, row in rp.top_solve:
            _lsolve_wave(Lx, x, rp.sol[cid], row, *meta[cid][:3])
        for cid, row in reversed(rp.top_solve):
            _ltsolve_wave(Lx, x, rp.sol[cid], row, *meta[cid][:3])
        xm.copy_(x)
        return ()

    def backward():
        x.copy_(xm)
        for cid, row in reversed(rp.phase1):
            _ltsolve_wave(Lx, x, rp.sol[cid], row, *meta[cid][:3])
        delta.copy_(x - xm)
        return ()

    key = (mesh.rank, int(k), dt, dev)
    got = rs.solves[k] = _RankSolve(
        x0=x0, x=x, xm=xm, delta=delta,
        forward=DeviceProgram("dist_solve_forward",
                              ("dist_solve_forward",) + key, forward, dev),
        top=DeviceProgram("dist_solve_top", ("dist_solve_top",) + key, top,
                          dev),
        backward=DeviceProgram("dist_solve_backward",
                               ("dist_solve_backward",) + key, backward,
                               dev))
    return got


def _solve_local(f: DistFactor, bk: np.ndarray,
                 run=DeviceProgram.__call__) -> torch.Tensor:
    """This rank's part of the distributed solve of the (n, k) host
    right-hand side ``bk``: the forward subtree solves, one all-reduce of
    the disjoint x deltas, the replicated top solves, the backward
    subtree solves and a second all-reduce.  ``run`` as in
    ``_factor_local``.  Returns the permuted solution panel (xrows, k)."""
    dp, mesh = f.dp, f.mesh
    rs = _rank_programs(dp, mesh, f.Lx.dtype)
    rs.bind(f)
    sv = _rank_solve(rs, dp, mesh, bk.shape[1])
    b = torch.as_tensor(bk[f.perm], device=f.Lx.device).to(f.Lx.dtype)
    run(sv.forward, b)
    mesh.all_reduce(sv.delta, "solve")
    run(sv.top)
    run(sv.backward)
    mesh.all_reduce(sv.delta, "solve")
    return sv.xm + sv.delta


def distributed_factorize(A, mesh: Mesh = None, common=None, dtype=None,
                          oversub: int = 4, root_2d_min: int = 256,
                          root_2d_nb: int = 128, dp: DistPlan = None,
                          seq: str = "merge"):
    """Full distributed supernodal factorization (module docstring); a
    collective: every rank of the mesh calls it with the same A.

    Returns (DistFactor, Symbolic): the factor stays distributed (own
    regions per rank, the top replicated).  mesh: None is ``make_mesh()``
    on this rank's card (raises without one).  dtype: float64 on the CPU
    and float32 on the card unless given.  Pass a prebuilt ``dp``
    (build_dist_plan) to reuse the pattern across values."""
    from ..cholesky.super_numeric import _assemble_values, _first_nan_super
    from ..core.common import default_common
    from ..core.status import Status

    mesh = mesh if mesh is not None else make_mesh()
    cm = common or default_common()
    if dp is None:
        dp = build_dist_plan(A, mesh.ndev, cm, oversub=oversub,
                             root_2d_min=root_2d_min, root_2d_nb=root_2d_nb,
                             seq=seq)
    else:
        cm.info.update(dp.comm)
    if dp.ndev != mesh.ndev:
        raise ValueError(f"plan built for {dp.ndev} ranks, mesh has "
                         f"{mesh.ndev}")
    dtype = numpy_dtype(default_dtype(mesh.device) if dtype is None
                        else dtype)
    vals = torch.as_tensor(_assemble_values(A, dp.sym, dp.ss, dtype),
                           device=mesh.device)
    itemsize = int(np.dtype(dtype).itemsize)
    cm.info.update({k.replace("_elems", "_bytes"): v * itemsize
                    for k, v in dp.comm.items() if k.endswith("_elems")})
    m = []
    rs = _factor_local(vals, dp, mesh, m)
    Lx = rs.Lx
    # NaN check: one all-reduce (MAX) of this rank's flag
    bad = torch.isnan(Lx[:dp.Bloc + dp.Btop]).any().to(Lx.dtype).reshape(1)
    mesh.all_reduce(bad, "nan", op=dist.ReduceOp.MAX)
    # the factor handed out is a copy: a later refactorization, which
    # reuses the rank's buffer, leaves it as it is
    f = DistFactor(dp=dp, Lx=Lx.clone(), mesh=mesh, perm=dp.sym.perm,
                   minor=dp.plan.n, dtype=dtype)
    rs.bound.set(f, f.Lx)
    failed = bool(bad.item())          # synchronizes: the marks are read
    cm.info.update(dist_factor_time=_seconds(m[0], m[4]),
                   dist_phase1_time=_seconds(m[0], m[1]),
                   dist_boundary_time=_seconds(m[1], m[2]),
                   dist_phase2_time=_seconds(m[2], m[3]),
                   dist_root_time=_seconds(m[3], m[4]))
    if failed:
        cm.status = Status.NOT_POSDEF
        f.minor = _first_nan_super(dp.ss, f.gather().Lx)
    else:
        cm.status = Status.OK
    return f, dp.sym


def dist_factor_from_numpy(dp: DistPlan, own: np.ndarray, top: np.ndarray,
                           perm: np.ndarray, minor: int = None,
                           rank: int = None, device=None,
                           mesh: Mesh = None) -> DistFactor:
    """Adopt a distributed factor computed elsewhere (the JAX package's
    ``DistFactor.own`` (ndev, Bloc) and ``top`` arrays; its plans are
    identical by construction) as this rank's DistFactor.  mesh: None is
    ``make_mesh(device=device)``; rank, when given, must be its rank.
    minor defaults to n (a complete factor)."""
    mesh = mesh if mesh is not None else make_mesh(device=device)
    if rank is not None and rank != mesh.rank:
        raise ValueError(f"rank {rank} is not the mesh's rank {mesh.rank}")
    own = np.asarray(own)
    if own.shape != (dp.ndev, dp.Bloc):
        raise ValueError(f"own has shape {own.shape}, the plan "
                         f"({dp.ndev}, {dp.Bloc})")
    Lx = torch.zeros(dp.lbuf, dtype=torch_dtype(own.dtype),
                     device=mesh.device)
    Lx[:dp.Bloc] = torch.as_tensor(own[mesh.rank])
    Lx[dp.Bloc:dp.Bloc + dp.Btop] = torch.as_tensor(
        np.asarray(top)[:dp.Btop])
    return DistFactor(dp=dp, Lx=Lx, mesh=mesh, perm=np.asarray(perm),
                      minor=dp.plan.n if minor is None else int(minor),
                      dtype=np.dtype(own.dtype))


# ---------------------------------------------------------------------------
# Legacy per-level batch sharding (the reference's round-1 building block)
# ---------------------------------------------------------------------------

def distributed_level_step(mesh: Mesh, Lx, bucket, trash: int):
    """One elimination-level bucket batch-sharded over the ranks (the
    subtree program above supersedes it).  Each rank factors its
    ceil(B/ndev) panels; one all-gather shares the factored panels and
    their updates; every rank writes them and applies the extend-add
    through the bucket's host-sorted maps (segment sum and a write to
    unique targets, so duplicate targets need no atomics).  Entries aimed
    at ``trash`` are dropped.  Returns the new buffer on the mesh's
    device; a collective."""
    ndev, d = mesh.ndev, mesh.rank
    Np, Mb, base, B = bucket.Np, bucket.Mb, bucket.base, len(bucket.sids)
    Mp = Np + Mb
    Lx = torch.as_tensor(Lx, device=mesh.device).clone()
    dt, dev = Lx.dtype, Lx.device
    per = -(-B // ndev)
    lo, hi = min(d * per, B), min((d + 1) * per, B)
    m = hi - lo

    def part(a, fill):
        out = torch.full((per,) + a.shape[1:], fill, dtype=dt, device=dev)
        out[:m] = torch.as_tensor(a[lo:hi], dtype=dt, device=dev)
        return out

    Pl = Lx.new_zeros((per, Mp, Np))
    Pl[:m] = _panels(Lx, base, B, Mp, Np)[lo:hi]
    T = Pl[:, :Np, :]
    T = T + torch.tril(T, -1).transpose(1, 2)
    C = cholesky_or_nan(T + torch.diag_embed(part(bucket.padeye, 1.0)))
    if Mb:
        Bm = torch.linalg.solve_triangular(C.transpose(1, 2), Pl[:, Np:, :],
                                           upper=True, left=False)
        U = syrk(Bm)
        newP = torch.cat([C, Bm], dim=1)
    else:
        newP = C
    newP = (newP * part(bucket.rowmask, 0.0)[:, :, None]
            * part(bucket.colmask, 0.0)[:, None, :])
    pack = (torch.cat([newP.reshape(-1), U.reshape(-1)]) if Mb
            else newP.reshape(-1))
    full = torch.stack(mesh.all_gather(pack, "level_step"))
    npan = per * Mp * Np
    _panels(Lx, base, B, Mp, Np).copy_(
        full[:, :npan].reshape(ndev * per, Mp, Np)[:B])
    if Mb:
        src, ids, dst = bucket.segsum_maps(trash)
        Ua = full[:, npan:].reshape(-1)
        Lx[_index(dst, dev)] -= segment_sum(Ua[_index(src, dev)],
                                            _seg_lengths(ids, len(dst), dev))
    return Lx
