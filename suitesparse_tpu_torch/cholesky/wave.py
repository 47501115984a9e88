"""Wave-scheduled supernodal solves in PyTorch.

Counterpart of the solve half of suitesparse_tpu/cholesky/wave.py.  The
wave plan is the reference's, copied: every bucket is split into uniform
**waves** of ``W`` panels per padded shape class ``(Np, Mb)``, and each
wave is one contiguous slice of the flat factor buffer, with per-wave
operands (base offset, masks, solve maps) stacked per class.

The reference compiles the stream of waves as one XLA program (unrolled
or scanned with a switch over classes).  PyTorch runs eagerly, so the port
walks the same stream in a Python loop and updates the solution panel in
place.  ``wave_numeric`` (program="wave") is not ported yet; the pass-
forward program (pf.py) owns the factorization.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.sparse import INDEX
from .super_numeric import (NumericPlan, _index, _panels, _seg_lengths,
                            scatter_add_maps, segment_sum,
                            sorted_scatter_maps)


def _pad_to(a: np.ndarray, length: int, fill) -> np.ndarray:
    out = np.full((length,) + a.shape[1:], fill, dtype=a.dtype)
    out[:len(a)] = a
    return out


@dataclasses.dataclass
class _WaveClass:
    """Stacked per-wave operands for one (Np, Mb, W) shape class."""

    Np: int
    Mb: int
    W: int
    L: int                  # padded extend-add entry count
    K: int                  # padded extend-add segment count (>= k+1 always)
    CL: int                 # padded solve col-set length
    CK: int
    RL: int                 # padded solve row-update length
    RK: int
    base: np.ndarray        # (T,) flat offsets
    padeye: np.ndarray      # (T, W, Np)
    rowmask: np.ndarray     # (T, W, Np+Mb)
    colmask: np.ndarray     # (T, W, Np)
    src: np.ndarray         # (T, L) into U.reshape(-1)
    ids: np.ndarray         # (T, L) sorted segment ids
    dst: np.ndarray         # (T, K) sorted unique flat targets (pads in trash)
    colidx: np.ndarray      # (T, W, Np) global col index (pad = n)
    rowidx: np.ndarray      # (T, W, Mb) global row index (pad = n)
    c_src: np.ndarray       # (T, CL)
    c_dst: np.ndarray       # (T, CK)
    r_src: np.ndarray       # (T, RL)
    r_ids: np.ndarray       # (T, RL)
    r_dst: np.ndarray       # (T, RK)


@dataclasses.dataclass
class WavePlan:
    """Instruction-stream plan: classes + (class, position) per wave."""

    plan: NumericPlan
    classes: list[_WaveClass]
    instr_cls: np.ndarray   # (T,) class id per wave, schedule order
    instr_pos: np.ndarray   # (T,) position within the class stack
    buf: int                # factor buffer length (total + 1 + trash region)
    xpad: int               # extra trash rows for the solve buffer
    solve_only: bool = False  # factor extend-add maps skipped (pf program)
    _cache: dict = dataclasses.field(default_factory=dict)

    @property
    def meta(self):
        return tuple((c.Np, c.Mb, c.W, c.L, c.K, c.CL, c.CK, c.RL, c.RK)
                     for c in self.classes)

    def solve_arrays(self, dtype, device):
        """Per-class solve operands, cached per (dtype, device): slice
        offsets stay host ints, index maps become int64 tensors."""
        dev = torch.device(device)
        key = ("solve", dtype, dev)
        got = self._cache.get(key)
        if got is None:
            got = tuple(
                dict(base=c.base.tolist(),
                     padeye=torch.as_tensor(c.padeye, dtype=dtype,
                                            device=dev),
                     colidx=_index(c.colidx, dev),
                     rowidx=_index(c.rowidx, dev),
                     c_src=_index(c.c_src, dev), c_dst=_index(c.c_dst, dev),
                     r_src=_index(c.r_src, dev), r_dst=_index(c.r_dst, dev),
                     r_lens=(torch.stack([_seg_lengths(i, c.RK, dev)
                                          for i in c.r_ids])
                             if c.RL else None))
                for c in self.classes)
            self._cache[key] = got
        return got

    @property
    def seq(self) -> list[tuple[int, int]]:
        """The stream of waves as (class id, position) pairs."""
        return list(zip(self.instr_cls.tolist(), self.instr_pos.tolist()))


def build_wave_plan(plan: NumericPlan, solve_only: bool = False) -> WavePlan:
    """Split the per-level buckets into uniform waves and stack operands
    per shape class.  Pure host preprocessing (runs once per pattern).

    solve_only: skip the factor extend-add maps (the expensive part of this
    builder) — used when the pass-forward program (pf.py) owns the numeric
    phase and this plan only drives wave_lsolve/wave_ltsolve."""
    n, total = plan.n, plan.total
    trash = total
    # pass 1: enumerate waves in schedule order
    waves = []   # (key, dict of per-wave raw pieces)
    for lv in plan.levels:
        for b in lv:
            Np, Mb, B = b.Np, b.Mb, len(b.sids)
            Mp = Np + Mb
            W = int(b.W)
            nw = -(-B // W)
            for w in range(nw):
                lo, hi = w * W, min((w + 1) * W, B)
                breal = hi - lo
                base_w = b.base + lo * Mp * Np
                padeye = np.ones((W, Np))
                padeye[:breal] = b.padeye[lo:hi]
                rowmask = np.zeros((W, Mp))
                rowmask[:breal] = b.rowmask[lo:hi]
                colmask = np.zeros((W, Np))
                colmask[:breal] = b.colmask[lo:hi]
                colidx = np.full((W, Np), n, dtype=INDEX)
                colidx[:breal] = b.colidx[lo:hi]
                rowidx = np.full((W, Mb), n, dtype=INDEX)
                if Mb:
                    rowidx[:breal] = b.rowidx[lo:hi]
                if Mb and not solve_only:
                    src, ids, dst = scatter_add_maps(
                        b.dest[lo:hi].reshape(-1), trash)
                else:
                    src = ids = dst = np.empty(0, dtype=INDEX)
                # solve maps (same construction as _Bucket.solve_maps)
                cflat = colidx.reshape(-1)
                c_src, c_dst = sorted_scatter_maps(
                    np.where(cflat == n, -1, cflat))
                r_src, r_ids, r_dst = scatter_add_maps(rowidx.reshape(-1), n)
                waves.append(((Np, Mb, W), dict(
                    base=base_w, padeye=padeye, rowmask=rowmask,
                    colmask=colmask, colidx=colidx, rowidx=rowidx,
                    src=src, ids=ids, dst=dst,
                    c_src=c_src, c_dst=c_dst,
                    r_src=r_src, r_ids=r_ids, r_dst=r_dst)))

    # pass 2: group by class, pad map lengths to the class max
    keys = []
    by_class: dict[tuple, list] = {}
    for key, wv in waves:
        if key not in by_class:
            by_class[key] = []
            keys.append(key)
        by_class[key].append(wv)
    cls_id = {key: i for i, key in enumerate(keys)}

    classes = []
    kmax = 1
    xkmax = 1
    for key in keys:
        Np, Mb, W = key
        ws = by_class[key]
        L = max(len(w["src"]) for w in ws)
        # always >= k+1 so padded src entries can target a pad segment
        K = (max(len(w["dst"]) for w in ws) + 1) if L else 0
        # col-set maps are 1:1 (plain scatter-set), so src/dst share a length
        CL = max(len(w["c_src"]) for w in ws)
        CK = CL
        RL = max(len(w["r_src"]) for w in ws)
        RK = (max(len(w["r_dst"]) for w in ws) + 1) if RL else 0
        kmax = max(kmax, K)
        xkmax = max(xkmax, CK, RK)

        def stack(fn):
            return np.stack([fn(w) for w in ws])

        def padmap(name, length, k_name, k_len, dst_base):
            """Pad (src-like, ids-like, dst-like) triples per wave."""
            srcs, idss, dsts = [], [], []
            for w in ws:
                s, i, d = w[name], w[name.replace("src", "ids")], w[k_name]
                k = len(d)
                srcs.append(_pad_to(s, length, 0))
                idss.append(_pad_to(i, length, max(k_len - 1, 0)))
                dpad = np.concatenate([
                    d, dst_base + 1 + np.arange(k_len - k, dtype=INDEX)])
                dsts.append(dpad.astype(INDEX))
            return np.stack(srcs), np.stack(idss), np.stack(dsts)

        if L:
            src, ids, dst = padmap("src", L, "dst", K, trash)
        else:
            T = len(ws)
            src = ids = np.zeros((T, 0), dtype=INDEX)
            dst = np.zeros((T, 0), dtype=INDEX)
        # solve col-set: plain sorted+unique scatter (no ids); pad dst into
        # distinct trash rows past n so uniqueness holds
        c_srcs, c_dsts = [], []
        for w in ws:
            ck = len(w["c_dst"])
            c_srcs.append(_pad_to(w["c_src"], CL, 0))
            c_dsts.append(np.concatenate([
                w["c_dst"], n + 1 + np.arange(CL - ck, dtype=INDEX)
            ]).astype(INDEX))
        if RL:
            r_src, r_ids, r_dst = padmap("r_src", RL, "r_dst", RK, n)
        else:
            T = len(ws)
            r_src = r_ids = np.zeros((T, 0), dtype=INDEX)
            r_dst = np.zeros((T, 0), dtype=INDEX)

        classes.append(_WaveClass(
            Np=Np, Mb=Mb, W=W, L=L, K=K, CL=CL, CK=CK, RL=RL, RK=RK,
            base=np.array([w["base"] for w in ws], dtype=INDEX),
            padeye=stack(lambda w: w["padeye"]),
            rowmask=stack(lambda w: w["rowmask"]),
            colmask=stack(lambda w: w["colmask"]),
            src=src, ids=ids, dst=dst,
            colidx=stack(lambda w: w["colidx"]),
            rowidx=stack(lambda w: w["rowidx"]),
            c_src=np.stack(c_srcs), c_dst=np.stack(c_dsts),
            r_src=r_src, r_ids=r_ids, r_dst=r_dst))

    pos_ctr = {key: 0 for key in keys}
    instr_cls = np.empty(len(waves), dtype=np.int32)
    instr_pos = np.empty(len(waves), dtype=np.int32)
    for t, (key, _) in enumerate(waves):
        instr_cls[t] = cls_id[key]
        instr_pos[t] = pos_ctr[key]
        pos_ctr[key] += 1

    return WavePlan(plan=plan, classes=classes, instr_cls=instr_cls,
                    instr_pos=instr_pos, buf=total + 1 + kmax,
                    xpad=1 + xkmax, solve_only=solve_only)


def _dinv_layout(wp: "WavePlan"):
    """Per-class base offsets into the Dinv buffer (inverted diagonal
    blocks, classes with 8 < Np <= 128 only — the latency-bound regime
    where the explicit inverse wins; bigger/smaller classes keep their
    in-branch path)."""
    got = wp._cache.get("dinv_layout")
    if got is None:
        bases = []
        off = 0
        for c in wp.classes:
            if 8 < c.Np <= 128:
                bases.append(off)
                off += len(c.base) * c.W * c.Np * c.Np
            else:
                bases.append(-1)
        got = (tuple(bases), off)
        wp._cache["dinv_layout"] = got
    return got


# ---------------------------------------------------------------------------
# Solve programs (super_lsolve / super_ltsolve over the waves)
# ---------------------------------------------------------------------------

def solve_dinv(wp: WavePlan, Lx: torch.Tensor) -> torch.Tensor:
    """Invert every (8 < Np <= 128) diagonal block ONCE per factorization,
    into the per-factor Dinv buffer (cached by the caller): the solve then
    applies each wave's triangular solve as one product against the stored
    inverse instead of rebuilding it in every wave of every solve."""
    from .pf import _tri_inv_pow2
    bases, total = _dinv_layout(wp)
    ops = wp.solve_arrays(Lx.dtype, Lx.device)
    out = Lx.new_zeros(max(total, 1))
    for cops, (Np, Mb, W, *_r), b0 in zip(ops, wp.meta, bases):
        if b0 < 0:
            continue
        T = len(cops["base"])
        C = torch.stack([_panels(Lx, b, W, Np + Mb, Np)[:, :Np, :]
                         for b in cops["base"]]).reshape(T * W, Np, Np)
        C = C + torch.diag_embed(cops["padeye"].reshape(T * W, Np))
        inv = _tri_inv_pow2(C)
        out[b0:b0 + inv.numel()] = inv.reshape(-1)
    return out


def _tri_apply(C, xc, transpose):
    """Batched triangular solve of (W,Np,k) against (W,Np,Np): for the
    small-Np classes through the batch-folded explicit inverse
    (pf._tri_inv_pow2) and one product, as the reference does."""
    Np = C.shape[1]
    if 8 < Np <= 128:
        from .pf import _tri_inv_pow2
        Linv = _tri_inv_pow2(C)
        return (Linv.transpose(1, 2) if transpose else Linv) @ xc
    if transpose:
        return torch.linalg.solve_triangular(C.transpose(1, 2), xc,
                                             upper=True)
    return torch.linalg.solve_triangular(C, xc, upper=False)


def _lsolve_step(Np, Mb, W, CL, CK, RL, RK, dinv_base=-1):
    Mp = Np + Mb

    def step(Lx, x, Dv, pos, ops):
        P = _panels(Lx, ops["base"][pos], W, Mp, Np)
        xc = x[ops["colidx"][pos]]                      # (W, Np, k)
        if dinv_base >= 0:
            Li = _panels(Dv, dinv_base + pos * W * Np * Np, W, Np, Np)
            xc = Li @ xc
        else:
            C = P[:, :Np, :] + torch.diag_embed(ops["padeye"][pos])
            xc = _tri_apply(C, xc, transpose=False)
        k = x.shape[-1]
        x[ops["c_dst"][pos]] = xc.reshape(-1, k)[ops["c_src"][pos]]
        if Mb and RL:
            upd = P[:, Np:, :] @ xc
            u = upd.reshape(-1, k)[ops["r_src"][pos]]
            x[ops["r_dst"][pos]] -= segment_sum(u, ops["r_lens"][pos])
    return step


def _ltsolve_step(Np, Mb, W, CL, CK, RL, RK, dinv_base=-1):
    Mp = Np + Mb

    def step(Lx, x, Dv, pos, ops):
        P = _panels(Lx, ops["base"][pos], W, Mp, Np)
        xc = x[ops["colidx"][pos]]
        if Mb:
            xr = x[ops["rowidx"][pos]]
            xc = xc - P[:, Np:, :].transpose(1, 2) @ xr
        if dinv_base >= 0:
            Li = _panels(Dv, dinv_base + pos * W * Np * Np, W, Np, Np)
            xc = Li.transpose(1, 2) @ xc
        else:
            C = P[:, :Np, :] + torch.diag_embed(ops["padeye"][pos])
            xc = _tri_apply(C, xc, transpose=True)
        k = x.shape[-1]
        x[ops["c_dst"][pos]] = xc.reshape(-1, k)[ops["c_src"][pos]]
    return step


def _run(wp, Lx, x, Dv, transpose, seq):
    """Walk ``seq`` of (class, position) waves, updating x in place."""
    ops = wp.solve_arrays(Lx.dtype, Lx.device)
    bases, _ = _dinv_layout(wp)
    mk = _ltsolve_step if transpose else _lsolve_step
    steps = [mk(Np, Mb, W, CL, CK, RL, RK, b0)
             for (Np, Mb, W, _L, _K, CL, CK, RL, RK), b0
             in zip(wp.meta, bases)]
    for cid, pos in seq:
        steps[cid](Lx, x, Dv, pos, ops[cid])
    return x


def wave_solve_llt(wp: WavePlan, Lx, bk, Dv=None, perm=None, invperm=None):
    """Fused L then Lt substitution; bk is the (n, k) permuted RHS -- or,
    when perm/invperm device index tensors are given, the UNpermuted RHS
    with the permutation applied on the device (returns (n, k)), so that
    repeated solves never round-trip the RHS through the host.
    Dv: per-factor inverted diagonal blocks (solve_dinv) -- built on the
    fly when not supplied."""
    if Dv is None:
        Dv = solve_dinv(wp, Lx)
    n, k = bk.shape
    x = Lx.new_zeros((wp.plan.n + wp.xpad, k))
    x[:n] = (bk[perm] if perm is not None else bk).to(Lx.dtype)
    seq = wp.seq
    _run(wp, Lx, x, Dv, False, seq)
    _run(wp, Lx, x, Dv, True, reversed(seq))
    return x[invperm] if invperm is not None else x


def wave_lsolve(wp: WavePlan, Lx, x, Dv=None):
    """L-solve of the padded (n + xpad, k) panel x, in place; returns x."""
    if Dv is None:
        Dv = solve_dinv(wp, Lx)
    return _run(wp, Lx, x, Dv, False, wp.seq)


def wave_ltsolve(wp: WavePlan, Lx, x, Dv=None):
    """Lt-solve of the padded (n + xpad, k) panel x, in place; returns x."""
    if Dv is None:
        Dv = solve_dinv(wp, Lx)
    return _run(wp, Lx, x, Dv, True, reversed(wp.seq))
