"""The port's factor programs against the JAX reference, f64 on the CPU:
the pass-forward program's remaining instruction paths, the small-pattern
unrolled program, the wave program (program="wave"), the bfloat16 SYRK
option (syrk_bf16), the factorize_super front end and its NOT_POSDEF
contract."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky import pf as ref_pf
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.cholesky import wave as ref_wave
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.core.status import Status as RefStatus
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky import pf as port_pf
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.cholesky import wave as port_wave
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


@pytest.mark.parametrize("program", ["unrolled", "pf", "wave"])
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


@pytest.mark.parametrize("program", ["unrolled", "pf", "wave"])
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


@pytest.mark.parametrize("gen,arg", [("laplacian_3d", 7), ("laplacian_3d", 12),
                                     ("fem3d", 2000), ("laplacian_2d", 20)])
def test_wave_numeric_matches_reference(gen, arg):
    """The wave program on the same wave plan: the panel buffer entry by
    entry, trash region excluded."""
    outs = []
    for pkg in (REF, PORT):
        A = getattr(pkg[1], gen)(arg)
        cm, sym, ss, plan = _setup(pkg, A, program="wave")
        wp = plan.wave_plan()
        vals = pkg[3]._assemble_values(A, sym, ss, np.float64)
        if pkg is REF:
            outs.append(np.asarray(ref_wave.wave_numeric(vals, wp,
                                                         np.float64)))
        else:
            Lx = port_wave.wave_numeric(vals, wp, np.float64, device="cpu")
            assert Lx.dtype == torch.float64 and Lx.shape == (wp.buf,)
            outs.append(Lx.numpy())
        total = plan.total
    assert _rel(outs[1], outs[0], total) < 1e-13


def test_wave_refactorization_is_bit_repeatable():
    """tests/test_determinism.py pins the wave program as bit-repeatable:
    the port's sorted segment sums and unique scatters keep it so."""
    A = port_gen.laplacian_3d(7)
    cm, sym, ss, plan = _setup(PORT, A, program="wave")
    f1 = port_sn.factorize_super(A, sym, ss, plan=plan, common=cm,
                                 device="cpu")
    f2 = port_sn.factorize_super(A, sym, ss, plan=plan, common=cm,
                                 device="cpu")
    assert f1.ok and torch.equal(f1.Lx, f2.Lx)


def test_wave_numeric_refuses_a_solve_only_plan():
    A = port_gen.laplacian_3d(6)
    cm, sym, ss, plan = _setup(PORT, A)
    wp = plan.wave_plan(solve_only=True)
    vals = port_sn._assemble_values(A, sym, ss, np.float64)
    with pytest.raises(ValueError, match="solve_only"):
        port_wave.wave_numeric(vals, wp, np.float64, device="cpu")


@pytest.mark.parametrize("program", ["unrolled", "wave"])
def test_syrk_bf16_matches_reference(program):
    """syrk_bf16 in float64: the reference's einsum of bfloat16 inputs
    summed in float64 against the port's rounded inputs multiplied in
    float64 (products of bf16 values are exact), 1e-12 relative; the
    bf16 factor differs from the plain one, so the option took effect."""
    fs = []
    for pkg in (REF, PORT):
        A = pkg[1].laplacian_3d(12)
        cm, sym, ss, plan = _setup(pkg, A, program=program, syrk_bf16=True)
        kw = {} if pkg is REF else {"device": "cpu"}
        f = pkg[3].factorize_super(A, sym, ss, plan=plan, common=cm,
                                   dtype=np.float64, **kw)
        assert f.ok
        fs.append(np.asarray(f.Lx) if pkg is REF else f.Lx.numpy())
        total = plan.total
    assert _rel(fs[1], fs[0], total) < 1e-12
    A = port_gen.laplacian_3d(12)
    cm, sym, ss, plan = _setup(PORT, A, program=program)
    plain = port_sn.factorize_super(A, sym, ss, plan=plan, common=cm,
                                    device="cpu").Lx.numpy()
    diff = _rel(fs[1], plain, total)
    assert 1e-6 < diff < 1e-2


def test_syrk_helper_rounds_inputs_not_the_sum():
    """syrk(B, bf16=True) is the product of the bf16-rounded inputs summed
    in B's dtype; a bf16 matmul would round the result too."""
    rng = np.random.default_rng(0)
    B = torch.as_tensor(rng.standard_normal((3, 17, 9)))
    Bs = B.to(torch.bfloat16).to(torch.float64)
    got = port_sn.syrk(B, bf16=True)
    assert got.dtype == torch.float64
    assert torch.allclose(got, Bs @ Bs.transpose(1, 2), rtol=0, atol=1e-13)
    assert not torch.equal(got, port_sn.syrk(B))
    low = (Bs.to(torch.bfloat16) @ Bs.to(torch.bfloat16).transpose(1, 2))
    assert not torch.equal(got, low.to(torch.float64))


def _map_case(case):
    """lap3d at a small grid; a full-storage SPD matrix whose columns hold
    their entries out of order; an upper- and a lower-stored copy of it."""
    if case == "lap3d":
        return port_gen.laplacian_3d(7)
    A = port_gen.random_spd(300, density=0.02, seed=3)
    col = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    order = np.lexsort((np.random.default_rng(4).random(A.nnz), col))
    full = PortCSC(A.indptr, A.indices[order], A.data[order], A.shape,
                   sorted=False)
    assert not np.array_equal(full.indices, A.indices)
    if case == "full_unsorted":
        return full
    half = full.triu(0) if case == "upper" else full.tril(0)
    half.stype = 1 if case == "upper" else -1
    return half


@pytest.mark.parametrize("case", ["lap3d", "full_unsorted", "upper", "lower"])
def test_value_map_gathers_the_assembled_values_bit_for_bit(case):
    A = _map_case(case)
    cm, sym, ss, plan = _setup(PORT, A)
    vmap = port_sn._value_map(plan, A, sym)
    assert vmap.dtype == np.int32
    for dt in (np.float64, np.float32):
        want = port_sn._assemble_values(A, sym, ss, dt)
        got = A.data[vmap].astype(dt)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


def _solver(A, program):
    cm = port_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = program
    return port_chol.CholeskySolver(sym=port_chol.analyze(A, cm), common=cm,
                                    device="cpu")


@pytest.mark.parametrize("program", ["unrolled", "pf", "wave"])
def test_refactorize_through_the_value_map_gives_the_same_factor(program):
    """Each refactorization's factor equals the program's result on the
    values assembled by the symperm, transpose and sort chain."""
    A = port_gen.laplacian_3d(7)
    solver = _solver(A, program)
    for scale in (1.0, 2.0, 0.5):
        B = PortCSC(A.indptr.copy(), A.indices.copy(), A.data * scale,
                    A.shape)
        solver.refactorize(B)
        vals = port_sn._assemble_values(B, solver.sym, solver.ss, np.float64)
        prog = port_sn.factor_program(solver.plan, solver.common, np.float64,
                                      torch.device("cpu"))
        assert solver.factor.ok
        assert torch.equal(solver.factor.Lx, prog(torch.as_tensor(vals)))


def test_value_map_is_made_once_per_pattern_and_layout():
    from suitesparse_tpu_torch.utils import trace
    trace.reset()
    try:
        A = port_gen.laplacian_3d(6)
        solver = _solver(A, "pf")
        # three value sets, each a new matrix with its own index arrays
        for scale in (1.0, 2.0, 3.0):
            solver.refactorize(PortCSC(A.indptr.copy(), A.indices.copy(),
                                       A.data * scale, A.shape))
        got = trace.snapshot()
        assert got["plan.value_map"]["count"] == 1
        assert got["super.factorize.assemble"]["count"] == 3
        assert {c.parent for c in got["plan.value_map"]["calls"]} == {
            "super.factorize/super.factorize.assemble"}
        full = solver.factor.Lx.clone()
        # the same matrix stored as its upper triangle: a second build
        U = PortCSC(A.indptr, A.indices, A.data * 3.0, A.shape).triu(0)
        U.stype = 1
        solver.refactorize(U)
        got = trace.snapshot()
        assert got["plan.value_map"]["count"] == 2
        assert got["super.factorize.assemble"]["count"] == 4
        assert torch.equal(solver.factor.Lx, full)
    finally:
        trace.reset()
