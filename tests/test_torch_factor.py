"""The port's factor programs against the JAX reference, f64 on the CPU:
the pass-forward program's remaining instruction paths, the small-pattern
unrolled program, the factorize_super front end and its NOT_POSDEF
contract."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky import pf as ref_pf
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.core.status import Status as RefStatus
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky import pf as port_pf
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import Status as PortStatus
from suitesparse_tpu_torch.io import generators as port_gen

REF = (ref_chol, ref_gen, ref_common, ref_sn, ref_pf)
PORT = (port_chol, port_gen, port_common, port_sn, port_pf)


def _setup(pkg, A, **opts):
    chol, _, common, sn, _ = pkg
    cm = common()
    cm.cholesky.supernodal = "supernodal"
    for k, v in opts.items():
        setattr(cm.cholesky, k, v)
    sym = chol.analyze(A, cm)
    ss = chol.super_symbolic(A, sym, cm)
    return cm, sym, ss, sn.build_plan(ss)


def _rel(got, want, total):
    return (np.abs(got[:total] - want[:total]).max()
            / max(np.abs(want[:total]).max(), 1.0))


def _pf_pair(gen, arg, **opts):
    out = []
    for pkg in (REF, PORT):
        A = getattr(pkg[1], gen)(arg)
        cm, sym, ss, plan = _setup(pkg, A, **opts)
        out.append((plan, pkg[4].build_pf_plan(plan, cm),
                    pkg[3]._assemble_values(A, sym, ss, np.float64)))
    return out


def test_pf_numeric_chunk_projections_match_reference():
    """pf_group='chunk' drives the projection (proj) instruction class."""
    (rp, rq, rv), (pp, pq, pv) = _pf_pair("laplacian_3d", 10,
                                          pf_group="chunk", pf_mode="project")
    assert len(pq.pmeta) > 0
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64))
    got = port_pf.pf_numeric(pv, pq, np.float64, device="cpu").numpy()
    assert _rel(got, want, rp.total) < 1e-13


def test_pf_numeric_all_pair_paths_match_reference():
    """laplacian_3d(16) has pair instructions of every kind: contiguous
    and slab-scatter placements (pad slabs dropped), span and per-slab
    gathers, and one-hot and gather row placement (Mbc > 256)."""
    (rp, rq, rv), (pp, pq, pv) = _pf_pair("laplacian_3d", 16)
    kinds = set()
    for Mbc, G, Pq, Npt, Mbt, pc, uc, spanq in pq.qmeta:
        kinds |= {("pc", pc), ("span", bool(spanq)), ("big", Mbc > 256)}
        if Mbt:
            kinds.add(("uc", uc))
    assert len(kinds) == 8, kinds
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64))
    got = port_pf.pf_numeric(pv, pq, np.float64, device="cpu").numpy()
    assert _rel(got, want, rp.total) < 1e-13


@pytest.mark.parametrize("gen,arg", [("laplacian_3d", 8), ("fem3d", 2000)])
def test_unrolled_program_matches_reference(gen, arg):
    """The small-pattern program (<= wave_threshold buckets)."""
    outs = []
    for pkg in (REF, PORT):
        A = getattr(pkg[1], gen)(arg)
        cm, sym, ss, plan = _setup(pkg, A)
        assert plan.resolve_program(cm) == "unrolled"
        vals = pkg[3]._assemble_values(A, sym, ss, np.float64)
        a_src, a_dst = pkg[3]._a_sorted_maps(ss)
        if pkg is REF:
            outs.append(np.asarray(ref_sn._numeric_program(
                jnp.asarray(vals), jnp.asarray(a_src), jnp.asarray(a_dst),
                plan.arrays_segsum(np.float64), plan.meta, plan.total,
                True, False)))
        else:
            outs.append(port_sn._numeric_program(
                torch.from_numpy(vals), torch.from_numpy(a_src),
                torch.from_numpy(a_dst),
                plan.arrays_segsum(np.float64, "cpu"), plan.meta,
                plan.total).numpy())
        total = plan.total
    assert _rel(outs[1], outs[0], total) < 1e-13


@pytest.mark.parametrize("program", ["unrolled", "pf"])
def test_factorize_super_matches_reference(program):
    fs = []
    for pkg in (REF, PORT):
        A = pkg[1].laplacian_3d(9)
        cm, sym, ss, plan = _setup(pkg, A, program=program)
        kw = {} if pkg is REF else {"device": "cpu"}
        f = pkg[3].factorize_super(A, sym, ss, plan=plan, common=cm, **kw)
        assert f.ok and cm.status == 0
        fs.append(f)
    assert np.dtype(fs[1].dtype) == np.float64
    assert fs[1].Lx.dtype == torch.float64
    assert _rel(fs[1].Lx.numpy(), np.asarray(fs[0].Lx),
                fs[0].plan.total) < 1e-13


def _indefinite(cls):
    """laplacian_3d(7) with one negative diagonal entry mid-ordering."""
    S = sp.csc_matrix(ref_gen.laplacian_3d(7).to_scipy())
    S = S.tolil()
    S[150, 150] = -3.0
    S = sp.csc_matrix(S)
    S.sort_indices()
    return cls.from_scipy(S)


@pytest.mark.parametrize("program", ["unrolled", "pf"])
def test_not_posdef_matches_reference(program):
    got = []
    for pkg, cls, status in ((REF, RefCSC, RefStatus),
                             (PORT, PortCSC, PortStatus)):
        A = _indefinite(cls)
        cm, sym, ss, plan = _setup(pkg, A, program=program)
        kw = {} if pkg is REF else {"device": "cpu"}
        f = pkg[3].factorize_super(A, sym, ss, plan=plan, common=cm, **kw)
        assert cm.status == status.NOT_POSDEF and not f.ok
        got.append((int(cm.status), f.minor))
    assert got[0] == got[1]
    assert got[1][1] < 343
