"""The PyTorch port's host plans are identical to the JAX reference's.

Orderings, elimination tree, supernode partition, panel layout, the
pass-forward instruction stream with every stacked operand array, and the
wave-plan solve arrays must match exactly: the port's factor buffer is
then interchangeable with the reference's, entry by entry.
"""
import numpy as np
import pytest

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky.pf import build_pf_plan as ref_build_pf
from suitesparse_tpu.cholesky.super_numeric import build_plan as ref_build
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky.pf import build_pf_plan as port_build_pf
from suitesparse_tpu_torch.cholesky.super_numeric import (
    build_plan as port_build)
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.io import generators as port_gen

MATRICES = [("laplacian_2d", (20,)), ("laplacian_3d", (8,)),
            ("laplacian_3d", (12,)), ("fem3d", (2000,))]


def _plans(gen, args, pf_mode="auto"):
    out = []
    for chol, gens, common, build, build_pf in (
            (ref_chol, ref_gen, ref_common, ref_build, ref_build_pf),
            (port_chol, port_gen, port_common, port_build, port_build_pf)):
        A = getattr(gens, gen)(*args)
        cm = common()
        cm.cholesky.supernodal = "supernodal"
        cm.cholesky.pf_mode = pf_mode
        sym = chol.analyze(A, cm)
        ss = chol.super_symbolic(A, sym, cm)
        plan = build(ss)
        out.append((sym, ss, plan, build_pf(plan, cm)))
    return out


def _same(a, b, what):
    """Exact structural equality of nested tuples/lists/dicts/arrays."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("gen,args", MATRICES)
def test_symbolic_and_layout_identical(gen, args):
    (rs, rss, rp, _), (ps, pss, pp, _) = _plans(gen, args)
    _same(rs.perm, ps.perm, "perm")
    _same(rs.parent, ps.parent, "etree")
    for name in ("super", "col_to_super", "sn_rowptr", "sn_rows",
                 "panel_off", "panel_Np", "panel_Mp", "sn_parent",
                 "a_scatter_dst", "a_scatter_src"):
        _same(getattr(rss, name), getattr(pss, name), name)
    assert rss.total == pss.total and rss.nsuper == pss.nsuper
    _same([[(Np, Mb, base, sids, W) for Np, Mb, base, sids, W in lv]
           for lv in rss.level_buckets],
          [[(Np, Mb, base, sids, W) for Np, Mb, base, sids, W in lv]
           for lv in pss.level_buckets], "level_buckets")
    _same(rp.meta, pp.meta, "plan.meta")
    for lr, lp in zip(rp.levels, pp.levels):
        for br, bp in zip(lr, lp):
            for name in ("sids", "padeye", "rowmask", "colmask", "colidx",
                         "rowidx"):
                _same(getattr(br, name), getattr(bp, name), name)
            _same(br.segsum_maps(rp.total), bp.segsum_maps(pp.total),
                  "segsum_maps")
            _same(br.solve_maps(rp.n), bp.solve_maps(pp.n), "solve_maps")


@pytest.mark.parametrize("pf_mode", ["project", "scatter", "auto"])
@pytest.mark.parametrize("gen,args", MATRICES)
def test_pf_plan_identical(gen, args, pf_mode):
    (_, _, _, rq), (_, _, _, pq) = _plans(gen, args, pf_mode)
    _same(rq.fmeta, pq.fmeta, "fmeta")
    _same(rq.pmeta, pq.pmeta, "pmeta")
    _same(rq.qmeta, pq.qmeta, "qmeta")
    _same(rq.fops, pq.fops, "fops")
    _same(rq.pops, pq.pops, "pops")
    _same(rq.qops, pq.qops, "qops")
    _same(rq.instr_cls, pq.instr_cls, "instr_cls")
    _same(rq.instr_pos, pq.instr_pos, "instr_pos")
    assert (rq.buf, rq.ub_total, rq.scat_entries) == \
        (pq.buf, pq.ub_total, pq.scat_entries)
    assert rq.proj_flops == pq.proj_flops


@pytest.mark.parametrize("gen,args", MATRICES)
def test_wave_solve_plan_identical(gen, args):
    (_, _, rp, _), (_, _, pp, _) = _plans(gen, args)
    rw, pw = rp.wave_plan(solve_only=True), pp.wave_plan(solve_only=True)
    _same(rw.meta, pw.meta, "wave meta")
    _same(rw.instr_cls, pw.instr_cls, "instr_cls")
    _same(rw.instr_pos, pw.instr_pos, "instr_pos")
    assert (rw.buf, rw.xpad) == (pw.buf, pw.xpad)
    for cr, cp in zip(rw.classes, pw.classes):
        for name in ("base", "padeye", "rowmask", "colmask", "colidx",
                     "rowidx", "c_src", "c_dst", "r_src", "r_ids", "r_dst"):
            _same(getattr(cr, name), getattr(cp, name), name)


def test_pf_plan_chunk_group_identical():
    """pf_group='chunk' exercises the projection (proj) instruction class."""
    plans = []
    for chol, gens, common, build, build_pf in (
            (ref_chol, ref_gen, ref_common, ref_build, ref_build_pf),
            (port_chol, port_gen, port_common, port_build, port_build_pf)):
        A = gens.laplacian_3d(10)
        cm = common()
        cm.cholesky.supernodal = "supernodal"
        cm.cholesky.pf_group = "chunk"
        cm.cholesky.pf_mode = "project"
        sym = chol.analyze(A, cm)
        plans.append(build_pf(build(chol.super_symbolic(A, sym, cm)), cm))
    rq, pq = plans
    assert len(rq.pmeta) > 0
    _same(rq.pmeta, pq.pmeta, "pmeta")
    _same(rq.pops, pq.pops, "pops")
    _same(rq.instr_cls, pq.instr_cls, "instr_cls")
