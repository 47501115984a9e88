"""Time by subtraction: the pf refactorization with pieces removed, the
counterpart of tools/ablate_pf.py.

    python -m suitesparse_tpu_torch.tools.ablate_pf [matrix] [variant ...]

builds the matrix's pf plan once (default lap3d_28) and captures each
variant as a device program over the same plan:

  full      ``pf_program`` itself; the tool's copy of
            ``pf._factor_step`` with nothing removed, beside
            ``pf._pair_step``, is checked against it bit for bit and node
            for node, once
  noproj    the projection and pair instructions dropped (factor waves
            only)
  nosyrk    factor waves: POTRF + TRSM and the panel write only (no SYRK,
            incoming update, update write or scatter)
  nopotrf   factor waves: no POTRF/TRSM (the symmetrized block is written
            back as the factor); SYRK and the rest as in full
  slices    factor waves: each panel read and written back (x 1.0000001)
  noscat    the mode-2 sorted-segment scatter dropped
  qgather0  pair instructions: the slab gather only
  qgather1  pair instructions: + the one-hot and the row placement
  qeinsum   pair instructions: + the contractions (the writes dropped)

and times each variant's replay in pairs with full's (alternating which
runs first, each on the host clock ended by a sync).  All variants but
full are numerically WRONG: this is a timing tool.  The reference's
``u-`` and scan forms have no counterpart: the port has one straight-line
program.  Runs on the card unless ``device="cpu"`` is asked for, where the
bodies run eagerly and the times are host times of the CPU.

The q variants cut the staged chain that placed the pair projections
before the extend-add kernel (``pf.extend_add``), as the reference still
does: a slab gather, a one-hot ``Wh``, the row placement and the
contractions against it; they show what each stage of that chain costs.
Every other variant runs ``pf._pair_step`` as ``pf_program`` does.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..cholesky.kernels import block_chol, panel_factor
from ..cholesky.pf import (_POTRF_MAXNP, _pair_ops, _pair_step, extend_add,
                           pf_program)
from ..cholesky.super_numeric import (_device_amaps, _index, _panels,
                                      assemble, cholesky_or_nan, segment_sum,
                                      syrk)
from ..utils.device import resolve_device, torch_dtype
from ..utils.programs import DeviceProgram
from .profile_attrib import pf_setup

__all__ = ["VARIANTS", "instructions", "main", "variant_program"]

VARIANTS = ("full", "noproj", "nosyrk", "nopotrf", "slices", "noscat",
            "qgather0", "qgather1", "qeinsum")
PAIRS = 5                  # timed pairs of full and each variant


def _factor_step(variant, Np, Mb, W, mode, L, K):
    """``pf._factor_step`` (float factor, no bf16 SYRK, trsm_inv) with the
    piece ``variant`` names removed."""
    Mp = Np + Mb

    def step(Fx, pos, ops):
        P = _panels(Fx, ops["base"][pos], W, Mp, Np)
        if variant == "slices":
            P.mul_(1.0000001)
            return
        pe = ops["padeye"][pos]
        rm = ops["rowmask"][pos]
        cmk = ops["colmask"][pos]
        if variant == "nopotrf" or Np > _POTRF_MAXNP:
            T = torch.tril(P[:, :Np, :])
            Tfull = T + torch.tril(T, -1).transpose(1, 2)
            Tfull = Tfull + torch.diag_embed(pe)
            if variant == "nopotrf":
                newP = torch.cat([Tfull, P[:, Np:, :]], dim=1)
            else:
                C = cholesky_or_nan(Tfull)
                newP = C
                if Mb:
                    newP = torch.cat([C, torch.linalg.solve_triangular(
                        C.transpose(1, 2), P[:, Np:, :], upper=True,
                        left=False)], dim=1)
            newP = newP * rm[:, :, None] * cmk[:, None, :]
        else:
            newP = panel_factor(P, pe, rm, cmk)
        upd = Mb and variant != "nosyrk"
        if upd:
            slot = _panels(Fx, ops["ubs"][pos], W, Mb, Mb)
            acc = torch.tril(slot)
            U = syrk(newP[:, Np:, :]) + acc + torch.tril(acc, -1).transpose(
                1, 2)
        P.copy_(newP)
        if upd and mode == 1:
            slot.copy_(U)
        if upd and mode == 2 and L and variant != "noscat":
            seg = segment_sum(U.reshape(-1)[ops["src"][pos]],
                              ops["lens"][pos])
            dst = ops["dst"][pos]
            Fx[dst] += seg * ops["sgn"][pos]
    return step


def _chain_ops(ops, meta, buf, dev):
    """The staged chain's operands of a pair class: ``pf._pair_ops``'s,
    with the frame row maps as int64 (torch gathers with int64 only), and
    the span gather's start and slab selection where the plan has them."""
    out = dict(_pair_ops(ops, meta, buf, dev), idxf=_index(ops["idxf"], dev))
    if meta[7]:
        out.update(g0=ops["g0"].tolist(),
                   gsel=_index(ops["gsel"].reshape(len(ops["gsel"]), -1),
                               dev))
    return out


def _chain_step(variant, Mbc, G, Pq, Npt, Mbt, pc, uc, spanq):
    """The staged chain of a pair projection (no bf16 placement) cut after
    the stage ``variant`` names (qgather0, qgather1, qeinsum); a cut stage
    adds one value of what it computed into Fx[0], as the reference's
    does."""
    Mft = Npt + Mbt
    ssz = Mbc * Mbc

    def step(Fx, pos, ops):
        idxf = ops["idxf"][pos]
        if spanq:
            g0 = ops["g0"][pos]
            Uc = Fx[g0:g0 + spanq * ssz].view(spanq, ssz)[ops["gsel"][pos]]
        else:
            Uc = Fx[ops["coff"][pos][..., None]
                    + torch.arange(ssz, device=Fx.device)]
        Uc = Uc.reshape(Pq, G, Mbc, Mbc)
        if variant == "qgather0":
            Fx[:1] += Uc[:, :, 0, 0].sum()
            return
        Wh = (idxf[..., None] == torch.arange(Mbc, device=Fx.device)).to(
            Fx.dtype)
        if Mbc <= 256:
            R = Wh @ Uc
        else:
            Ucz = torch.cat([Uc, Uc.new_zeros((Pq, G, 1, Mbc))], dim=2)
            R = torch.gather(Ucz, 2, idxf[..., None].expand(Pq, G, Mft, Mbc))
        if variant == "qgather1":
            Fx[:1] += R[:, :, 0, 0].sum() + Wh[:, :, 0, 0].sum()
            return
        S = torch.einsum("pgfm,pghm->pfh", R, Wh[:, :, :Npt, :])
        St = (torch.tril(torch.einsum("pgfm,pghm->pfh", R[:, :, Npt:, :],
                                      Wh[:, :, Npt:, :])) if Mbt else None)
        Fx[:1] += S[:, 0, 0].sum() + (St[:, 0, 0].sum() if Mbt else 0.0)
    return step


def instructions(pfp, variant: str) -> list:
    """The (class, position) stream a variant runs: ``noproj`` keeps the
    factor instructions only, the others all of them."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of "
                         f"{', '.join(VARIANTS)})")
    nf = len(pfp.fmeta)
    return [(c, p) for c, p in zip(pfp.instr_cls.tolist(),
                                   pfp.instr_pos.tolist())
            if variant != "noproj" or c < nf]


def variant_program(pfp, variant: str, dtype, device) -> DeviceProgram:
    """The variant's device program over the plan ``pfp`` (not cached on
    the plan).  Chunk-grouped projections (pf_group="chunk") are not
    ablated: the reference's tool has the pair grouping only."""
    if pfp.pmeta:
        raise ValueError("ablate_pf: the plan has chunk-grouped projections")
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    fops, _, qops = pfp.arrays(dt, dev)
    steps = [(_factor_step(variant, *m), o) for o, m in zip(fops, pfp.fmeta)]
    if variant.startswith("q"):
        steps += [(_chain_step(variant, *m),
                   _chain_ops(o, m, pfp.buf, dev))
                  for o, m in zip(pfp.qops, pfp.qmeta)]
    else:
        steps += [(_pair_step(*m), o) for o, m in zip(qops, pfp.qmeta)]
    stream = [steps[c] + (p,) for c, p in instructions(pfp, variant)]
    a_src, a_dst = _device_amaps(pfp._cache, pfp.plan.ss, dev)

    def body(vals):
        Fx = assemble(vals, a_src, a_dst, pfp.buf)
        for step, ops, pos in stream:
            step(Fx, pos, ops)
        return Fx
    return DeviceProgram(f"ablate_{variant}", ("ablate", variant, dt, dev),
                         body, dev, counters=(block_chol, extend_add))


def _timed(fn, dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def ablate(pfp, vals, variants=VARIANTS, pairs: int = PAIRS) -> dict:
    """Each variant's program, its replay timed in ``pairs`` pairs with
    ``pf_program``'s.  The tool's full copy must equal ``pf_program``'s
    result bit for bit, and its graph have as many nodes; it is freed
    after that check, and ``pf_program`` itself is the full side of the
    pairs.
    Returns {variant: {ms, full_ms, saved_ms, nodes, full_nodes}}
    (medians)."""
    dev = vals.device
    dt = vals.dtype
    full = pf_program(pfp, dt, device=dev)
    want = full(vals)
    copy = variant_program(pfp, "full", dt, dev)
    got = copy(vals)
    if not torch.equal(got, want) or copy.nodes != full.nodes:
        raise RuntimeError(f"ablate_pf: the full copy differs from "
                           f"pf_program ({copy.nodes} against {full.nodes} "
                           f"nodes)")
    del got, want, copy
    out = {}
    for v in variants:
        if v == "full":
            continue
        prog = variant_program(pfp, v, dt, dev)
        prog(vals)                 # warm-up and capture
        t_full, t_v = [], []
        for r in range(pairs):
            order = ((t_full, full), (t_v, prog))
            for times, p in (order if r % 2 == 0 else order[::-1]):
                times.append(_timed(lambda: p(vals), dev))
        out[v] = dict(ms=float(np.median(t_v)),
                      full_ms=float(np.median(t_full)),
                      saved_ms=float(np.median(t_full) - np.median(t_v)),
                      nodes=prog.nodes, full_nodes=full.nodes)
        del prog
    return out


def main(name: str = "lap3d_28", variants=VARIANTS, device=None,
         pairs: int = PAIRS) -> dict:
    """Build ``name``'s plan on ``device`` (the card unless "cpu" is asked
    for), ablate and print one line per variant."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    A, sym, pfp, vals = pf_setup(name, dev)
    print(f"[{name}] fl={sym.flops:.3g} projfl={pfp.proj_flops:.3g} "
          f"instr={len(pfp.instr_cls)} fcls={len(pfp.fmeta)} "
          f"qcls={len(pfp.qmeta)} ({dev.type}; every variant but full is "
          f"numerically wrong)", flush=True)
    res = ablate(pfp, vals, variants, pairs)
    for v, r in res.items():
        print(f"  {v:8s}: {r['ms']:9.2f} ms against full {r['full_ms']:9.2f}"
              f" ms (saves {r['saved_ms']:8.2f} ms; {r['nodes']} nodes)",
              flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "lap3d_28",
         tuple(sys.argv[2:]) or VARIANTS)
