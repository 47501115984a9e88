"""The port's device programs (utils/programs.py) against the JAX
reference's compiled programs, float64 on the CPU.

Each program of the slice -- the pf, wave and unrolled refactorizations,
the Cholesky solves, the multifrontal LU and its solves, KLU's device
twin -- runs two value sets on one plan through ONE program object, and
each result is held against the reference's jitted program on the same
seeded inputs: factors within 1e-13 relative, solves within 1e-12 (the
LU and KLU programs within their parity tests' 1e-12).  On the CPU a
program runs its body eagerly on its static buffers, so the tests also pin
the wrapper's contract: one program per key, reused, another for another
dtype, syrk_bf16, k or S; results that never share storage with the
static buffers or with an earlier result; and the NOT_POSDEF verdict with
the reference's minor."""
import numpy as np
import pytest
import torch
from scipy.sparse import identity as sp_identity

import jax
import jax.numpy as jnp

import suitesparse_tpu.cholesky as ref_chol
import suitesparse_tpu.lu as ref_lu
from suitesparse_tpu.cholesky import pf as ref_pf
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.cholesky import wave as ref_wave
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.io import generators as ref_gen

from suitesparse_tpu_torch.io.generators import cd3d
import suitesparse_tpu_torch.cholesky as port_chol
import suitesparse_tpu_torch.lu as port_lu
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.cholesky.kernels import block_chol
from suitesparse_tpu_torch.cholesky.pf import extend_add, pf_program
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import Status
from suitesparse_tpu_torch.io import generators as port_gen
from suitesparse_tpu_torch.lu.klu_device import (klu_refactor_program,
                                                 klu_solve_program)
from suitesparse_tpu_torch.lu.multifrontal import (umf_program,
                                                   umf_solve_program)
from suitesparse_tpu_torch.utils.programs import DeviceProgram

FACTOR_TOL = 1e-13
SOLVE_TOL = 1e-12
LU_TOL = 1e-12
SHIFTS = (0.0, 1.5)        # two value sets: A and A + 1.5 I


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _chol(chol, gens, common, sn, A=None, **opts):
    A = gens.laplacian_3d(9) if A is None else A
    cm = common()
    cm.cholesky.supernodal = "supernodal"
    for k, v in opts.items():
        setattr(cm.cholesky, k, v)
    sym = chol.analyze(A, cm)
    ss = chol.super_symbolic(A, sym, cm)
    return A, cm, sym, ss, sn.build_plan(ss)


def _ref_factor(program, cm, plan, sym, ss, vals):
    """The reference's compiled factor program on ``vals``."""
    if program == "pf":
        return np.asarray(ref_pf.pf_numeric(vals, ref_pf.build_pf_plan(
            plan, cm), np.float64))
    if program == "wave":
        return np.asarray(ref_wave.wave_numeric(vals, plan.wave_plan(),
                                                np.float64))
    a_src, a_dst = ref_sn._a_sorted_maps(ss)
    return np.asarray(ref_sn._numeric_program(
        jnp.asarray(vals), jnp.asarray(a_src), jnp.asarray(a_dst),
        plan.arrays_segsum(np.float64), plan.meta, plan.total, True, False))


@pytest.mark.parametrize("program", ["pf", "wave", "unrolled"])
def test_refactor_programs_match_reference(program):
    """Two value sets through one program object: each factor matches the
    reference's compiled program, and the first is unchanged by the
    second call."""
    Ar, rcm, rsym, rss, rplan = _chol(ref_chol, ref_gen, ref_common, ref_sn,
                                      program=program)
    A, cm, sym, ss, plan = _chol(port_chol, port_gen, port_common, port_sn,
                                 program=program)
    assert plan.resolve_program(cm) == program
    prog = port_sn.factor_program(plan, cm, np.float64, "cpu")
    assert isinstance(prog, DeviceProgram) and prog.key[0] == program
    got = []
    for beta in SHIFTS:
        want = _ref_factor(program, rcm, rplan, rsym, rss,
                           ref_sn._assemble_values(Ar, rsym, rss,
                                                   np.float64, beta))
        vals = torch.from_numpy(port_sn._assemble_values(A, sym, ss,
                                                         np.float64, beta))
        assert port_sn.factor_program(plan, cm, np.float64, "cpu") is prog
        Lx = prog(vals)
        assert Lx.dtype == torch.float64
        assert _rel(Lx[:plan.total], want[:plan.total]) < FACTOR_TOL
        got.append((Lx, Lx.clone()))
    (L1, L1_copy), (L2, _) = got
    assert torch.equal(L1, L1_copy)
    assert not torch.equal(L1[:plan.total], L2[:plan.total])
    for L, _ in got:
        assert L.data_ptr() != prog.static[0].data_ptr()


def test_factorize_super_reuses_the_program_and_reports_setup():
    """factorize_super runs the plan's program: the second factorization
    reuses it, and the setup of the first (0 on the CPU, which captures
    nothing) is reported apart from factor_time."""
    A, cm, sym, ss, plan = _chol(port_chol, port_gen, port_common, port_sn,
                                 program="pf")
    f1 = port_sn.factorize_super(A, sym, ss, plan=plan, common=cm,
                                 device="cpu")
    assert cm.info["factor_warmup_time"] == cm.info["factor_capture_time"] \
        == 0.0 and cm.info["factor_time"] > 0
    progs = dict(plan.pf_plan(cm)._cache)
    cm.info.clear()
    f2 = port_sn.factorize_super(A, sym, ss, plan=plan, common=cm,
                                 device="cpu")
    assert "factor_capture_time" not in cm.info
    assert dict(plan.pf_plan(cm)._cache) == progs
    assert torch.equal(f1.Lx, f2.Lx) and f1.Lx.data_ptr() != f2.Lx.data_ptr()


def test_one_program_per_key():
    """The key is (program, dtype, syrk_bf16, trsm_inv, device): the same
    options give the same object, each other value another."""
    A, cm, sym, ss, plan = _chol(port_chol, port_gen, port_common, port_sn,
                                 program="pf")
    pfp = plan.pf_plan(cm)
    base = pf_program(pfp, np.float64, device="cpu")
    assert pf_program(pfp, np.float64, device="cpu") is base
    assert base.counters == (block_chol, extend_add)
    others = [pf_program(pfp, np.float32, device="cpu"),
              pf_program(pfp, np.float64, syrk_bf16=True, device="cpu"),
              pf_program(pfp, np.float64, trsm_inv=False, device="cpu")]
    assert len({id(p) for p in [base] + others}) == 4
    assert len({p.key for p in [base] + others}) == 4


@pytest.mark.parametrize("program", ["pf", "unrolled"])
@pytest.mark.parametrize("k", [1, 4])
def test_solve_programs_match_reference(program, k):
    """Every device solve system on the reference's own factor (adopted by
    factor_from_numpy), k right-hand sides, two right-hand sides through
    one program per (system, k) cached on the plan."""
    Ar, rcm, rsym, rss, rplan = _chol(ref_chol, ref_gen, ref_common, ref_sn,
                                      program=program)
    rf = ref_sn.factorize_super(Ar, rsym, rss, plan=rplan, common=rcm)
    A, cm, sym, ss, plan = _chol(port_chol, port_gen, port_common, port_sn,
                                 program=program)
    f = port_sn.factor_from_numpy(plan, np.asarray(rf.Lx), sym.perm,
                                  device="cpu")
    rng = np.random.default_rng(k)
    shape = (A.ncol,) if k == 1 else (A.ncol, k)
    for system in ("A", "LLt", "L", "Lt"):
        prog = None
        xs = []
        for _ in range(2):
            b = rng.standard_normal(shape)
            want = ref_sn.solve_super(rf, b, system, rcm)
            x = port_sn.solve_super(f, b, system, cm)
            assert x.shape == b.shape
            assert _rel(x, want) < SOLVE_TOL, system
            p = port_sn.solve_program(plan, system, k, torch.float64, "cpu",
                                      cm)
            assert prog is None or p is prog
            prog = p
            xs.append((x, x.copy()))
        assert np.array_equal(*xs[0])
    wave = program == "pf"
    f64, cpu = torch.float64, torch.device("cpu")
    assert {key for key, v in plan._cache.items()
            if isinstance(v, DeviceProgram)} \
        == {("solve_" + s_, wave, f64, k, cpu)
            for s_ in ("A", "LLt", "L", "Lt")}
    assert set(plan._cache) >= {("solve_factor", wave, f64, cpu)}


def _eager_solve(f, b, system, cm):
    """The solve's body run on ``f``'s own buffers (no program, no bound
    factor): what each factor's solve must equal bit for bit."""
    plan = f.plan
    wave = plan.use_wave(cm)
    Dv = None
    if wave:
        from suitesparse_tpu_torch.cholesky.wave import solve_dinv
        Dv = solve_dinv(port_sn._solve_wave_plan(plan, cm), f.Lx)
    perm = torch.as_tensor(f.perm)
    body = port_sn._solve_body(plan, system, wave, cm, f.Lx, Dv, perm,
                               torch.argsort(perm))
    bk = torch.as_tensor(b.reshape(plan.n, -1))
    return body(bk).numpy().reshape(b.shape)


@pytest.mark.parametrize("program", ["pf", "unrolled"])
def test_two_factors_share_one_solve_program(program):
    """Two factors of one plan (A and A + 1.5 I) solve alternately (f1,
    f2, f1) through ONE program per (system, k) and one bound factor on
    the plan: each solution bit-identical to its own factor's eager solve
    and within 1e-12 of the reference's solve_super in float64; the
    binding copies only when the factor changes."""
    Ar, rcm, rsym, rss, rplan = _chol(ref_chol, ref_gen, ref_common, ref_sn,
                                      program=program)
    A, cm, sym, ss, plan = _chol(port_chol, port_gen, port_common, port_sn,
                                 program=program)
    port_fs, ref_fs = [], []
    for beta in SHIFTS:
        Ab = PortCSC.from_scipy((A.to_scipy()
                                 + beta * sp_identity(A.ncol)).tocsc())
        Arb = RefCSC.from_scipy((Ar.to_scipy()
                                 + beta * sp_identity(A.ncol)).tocsc())
        port_fs.append(port_sn.factorize_super(Ab, sym, ss, plan=plan,
                                               common=cm, device="cpu"))
        ref_fs.append(ref_sn.factorize_super(Arb, rsym, rss, plan=rplan,
                                             common=rcm))
    rng = np.random.default_rng(11)
    b = rng.standard_normal((A.ncol, 3))
    progs = set()
    R = None
    for i in (0, 1, 0, 0):
        f, rf = port_fs[i], ref_fs[i]
        for system in ("A", "LLt", "L", "Lt"):
            x = port_sn.solve_super(f, b, system, cm)
            assert np.array_equal(x, _eager_solve(f, b, system, cm)), system
            assert _rel(x, ref_sn.solve_super(rf, b, system, rcm)) \
                < SOLVE_TOL, system
            progs.add(id(port_sn.solve_program(plan, system, 3,
                                               torch.float64, "cpu", cm)))
        got = port_sn.bind_solve_factor(f, cm)
        assert R is None or got is R
        R = got
        assert R.bound.holds(f, f.Lx)
        assert not R.bound.holds(port_fs[1 - i], port_fs[1 - i].Lx)
        assert torch.equal(R.Lx, f.Lx[:plan.total])
    assert len(progs) == 4
    # a factor's values changed in place are copied in again
    f = port_fs[0]
    port_sn.bind_solve_factor(f, cm)
    f.Lx.mul_(1.0)
    assert not R.bound.holds(f, f.Lx)
    port_sn.bind_solve_factor(f, cm)
    assert R.bound.holds(f, f.Lx)


def test_not_posdef_minor_matches_reference():
    """laplacian_3d(6) - 4 I through each program: NOT_POSDEF with the
    reference's minor."""
    import scipy.sparse as sp
    S = ref_gen.laplacian_3d(6).to_scipy()
    S = sp.csc_matrix(S - 4.0 * sp.identity(S.shape[0]))
    S.sort_indices()
    for program in ("pf", "wave", "unrolled"):
        got = []
        for pkg, cls in (((ref_chol, ref_gen, ref_common, ref_sn), RefCSC),
                         ((port_chol, port_gen, port_common, port_sn),
                          PortCSC)):
            A, cm, sym, ss, plan = _chol(*pkg, A=cls.from_scipy(S),
                                         program=program)
            kw = {} if cls is RefCSC else {"device": "cpu"}
            f = pkg[3].factorize_super(A, sym, ss, plan=plan, common=cm,
                                       **kw)
            assert not f.ok and int(cm.status) == int(Status.NOT_POSDEF)
            got.append(f.minor)
        assert got[0] == got[1] < S.shape[0], program


def _lu_pair(A):
    Ar = RefCSC(A.indptr, A.indices, A.data, A.shape)
    rc, pc = ref_common(), port_common()
    return Ar, rc, pc, ref_lu.umf_symbolic(Ar, rc), \
        port_lu.umf_symbolic(A, pc)


def test_umf_programs_match_reference():
    """cd3d_8: two value sets through one numeric program, each numeric
    (L and U buffers, block pivots) against the reference's; the solve
    programs for A and At with k = 1 and 4, cached on the numeric."""
    A = cd3d(8)
    Ar, rc, pc, Sr, Sp = _lu_pair(A)
    assert Sp.singles is None
    rng = np.random.default_rng(3)
    nums = []
    prog = None
    for scale in (np.ones(A.nnz), 1.0 + 0.2 * rng.random(A.nnz)):
        A2 = PortCSC(A.indptr, A.indices, A.data * scale, A.shape)
        A2r = RefCSC(A.indptr, A.indices, A.data * scale, A.shape)
        nr = ref_lu.umf_numeric(A2r, Sr, rc)
        num = port_lu.umf_numeric(A2, Sp, pc, device="cpu")
        p = umf_program(Sp, np.float64, "cpu")
        assert prog is None or p is prog
        prog = p
        assert not num.singular and _rel(num.Lb, nr.Lb) <= LU_TOL
        assert _rel(num.Ub, nr.Ub) <= LU_TOL
        for lr, lp in zip(nr.pivs, num.pivs, strict=True):
            for pr, pp in zip(lr, lp, strict=True):
                assert np.array_equal(np.asarray(pr), pp.numpy())
        nums.append((num, num.Lb.clone(), nr))
        for k in (1, 4):
            b = rng.standard_normal(A.ncol if k == 1 else (A.ncol, k))
            for system in ("A", "At"):
                xr = ref_lu.umf_solve(nr, b, system, refine=0)
                xp = port_lu.umf_solve(num, b, system, refine=0)
                assert xp.shape == b.shape and _rel(xp, xr) <= LU_TOL
        assert {key[0] for key, v in Sp.plan._cache.items()
                if isinstance(v, DeviceProgram)} \
            == {"umf_numeric", "umf_lsolve", "umf_usolve", "umf_ltsolve",
                "umf_utsolve"}
        assert umf_solve_program(Sp, "lsolve", 4, False, torch.float64,
                                 "cpu") is \
            Sp.plan._cache[("umf_lsolve", False, torch.float64, 4,
                            torch.device("cpu"))]
    assert torch.equal(nums[0][0].Lb, nums[0][1])
    assert not torch.equal(nums[0][0].Lb, nums[1][0].Lb)


def test_two_numerics_share_one_umf_solve_program():
    """Two numerics of one symbolic solve alternately (n1, n2, n1) through
    one program per (name, conj, k) on the symbolic's plan: each solution
    bit-identical to its own numeric's eager solve and within 1e-12 of
    the reference's umf_solve in float64."""
    from suitesparse_tpu_torch.lu import multifrontal as port_mf
    A = cd3d(8)
    Ar, rc, pc, Sr, Sp = _lu_pair(A)
    rng = np.random.default_rng(4)
    pairs = []
    for scale in (np.ones(A.nnz), 1.0 + 0.2 * rng.random(A.nnz)):
        A2 = PortCSC(A.indptr, A.indices, A.data * scale, A.shape)
        A2r = RefCSC(A.indptr, A.indices, A.data * scale, A.shape)
        pairs.append((port_lu.umf_numeric(A2, Sp, pc, device="cpu"),
                      ref_lu.umf_numeric(A2r, Sr, rc)))
    b = rng.standard_normal((A.ncol, 2))
    progs = set()
    for i in (0, 1, 0):
        num, nr = pairs[i]
        for system in ("A", "At"):
            xp = port_lu.umf_solve(num, b, system, refine=0)
            assert _rel(xp, ref_lu.umf_solve(nr, b, system, refine=0)) \
                <= LU_TOL
        R = port_mf.bind_umf_numeric(num)
        other = pairs[1 - i][0]
        assert R.bound.holds(num, num.Lb, num.Ub)
        assert not R.bound.holds(other, other.Lb, other.Ub)
        for name in ("lsolve", "usolve", "ltsolve", "utsolve"):
            prog = umf_solve_program(Sp, name, 2, False, torch.float64,
                                     "cpu")
            progs.add(id(prog))
            z = torch.as_tensor(rng.standard_normal((A.ncol, 2)))
            own = port_mf._umf_solve_body(Sp, name, False, num.Lb, num.Ub,
                                          num.pivs)(z.clone())
            assert torch.equal(prog(z), own), name
    assert len(progs) == 4
    # a numeric's values changed in place are copied in again
    num = pairs[0][0]
    port_mf.bind_umf_numeric(num)
    num.Ub.mul_(2.0)
    assert not R.bound.holds(num, num.Lb, num.Ub)
    assert not torch.equal(R.Ub, num.Ub[:Sp.plan.total])
    assert port_mf.bind_umf_numeric(num) is R
    assert R.bound.holds(num, num.Lb, num.Ub)
    assert torch.equal(R.Ub, num.Ub[:Sp.plan.total])


def _klu_case():
    A = port_gen.circuit_like(300, seed=3)
    Ar = RefCSC(A.indptr, A.indices, A.data, A.shape)
    sr = ref_lu.klu_analyze(Ar)
    sp_ = port_lu.klu_analyze(A)
    return (A, Ar, ref_lu.klu_device(Ar, sr, ref_lu.klu_factor(Ar, sr)),
            port_lu.klu_device(A, sp_, port_lu.klu_factor(A, sp_),
                               device="cpu"))


def _close(a, b, tol=LU_TOL):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and _rel(a, b) <= tol


def test_klu_programs_match_reference():
    """KLU's device twin: single value sets and a sweep of 4 through the
    refactor and solve programs of (S, dtype) and (S, k, dtype), against
    the reference's jitted twin and its jax.vmap."""
    A, Ar, (_, rref, rsol), (plan, pref, psol) = _klu_case()
    rng = np.random.default_rng(5)
    n = A.ncol
    firsts = None
    for _ in range(2):
        av = A.data * (1.0 + 0.2 * rng.random(A.nnz))
        fr, Rr, okr = rref(jnp.asarray(av))
        fp, Rp, okp = pref(av)
        assert bool(okr) == bool(okp)
        assert all(_close(b, a) for a, b in zip(fr, fp))
        assert _close(Rp, Rr)
        for b in (rng.standard_normal(n), rng.standard_normal((n, 4))):
            xr = rsol(fr, Rr, jnp.asarray(av), jnp.asarray(b))
            assert _close(psol(fp, Rp, av, b), xr)
        if firsts is None:
            firsts = [(F, F.clone()) for F in fp]
    assert all(torch.equal(F, c) for F, c in firsts)
    sweep = A.data[None, :] * (1.0 + 0.2 * rng.random((4, A.nnz)))
    b = rng.standard_normal(n)
    fr, Rr, okr = jax.vmap(rref)(jnp.asarray(sweep))
    xr = jax.vmap(lambda f, r, a: rsol(f, r, a, jnp.asarray(b)))(
        fr, Rr, jnp.asarray(sweep))
    fp, Rp, okp = pref(torch.as_tensor(sweep))
    assert okp.tolist() == np.asarray(okr).tolist()
    assert all(_close(b_, a) for a, b_ in zip(fr, fp))
    assert _close(psol(fp, Rp, torch.as_tensor(sweep), b), xr)
    f64, dev = torch.float64, torch.device("cpu")
    keys = {key for key in plan._cache if isinstance(key, tuple)}
    assert keys == {("klu_refactor", 1, f64, dev),
                    ("klu_refactor", 4, f64, dev),
                    ("klu_solve", 1, 1, f64, dev),
                    ("klu_solve", 1, 4, f64, dev),
                    ("klu_solve", 4, 1, f64, dev)}
    assert klu_refactor_program(plan, 4, f64, dev) is \
        plan._cache[("klu_refactor", 4, f64, dev)]
    assert klu_solve_program(plan, 4, 1, torch.float32, dev) is not \
        klu_solve_program(plan, 4, 1, f64, dev)


def test_program_contract_on_the_cpu():
    """The wrapper itself: static buffers are copies of the first inputs,
    later inputs are copied in, results are clones (a result is never the
    static output, and a later call leaves it as it was), nested tuples and
    lists keep their structure, and an input of another shape is
    refused."""
    calls = []

    def body(x, y):
        calls.append(1)
        return x + y, (x, [y * 2])

    prog = DeviceProgram("toy", ("toy",), body, "cpu")
    assert not prog.prepared and prog.graph is None
    x, y = torch.ones(3), torch.arange(3.0)
    r1 = prog(x, y)
    assert prog.prepared and prog.static[0] is not x
    assert r1[1][0].data_ptr() != prog.static[0].data_ptr()
    assert isinstance(r1, tuple) and isinstance(r1[1][1], list)
    r2 = prog(2 * x, y)
    assert torch.equal(r1[0], torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(r2[0], torch.tensor([2.0, 3.0, 4.0]))
    assert torch.equal(prog.static[0], 2 * x) and len(calls) == 2
    x[0] = 5.0                     # the caller's tensors are not the buffers
    assert prog.static[0][0] == 2.0
    with pytest.raises(ValueError, match="toy"):
        prog(torch.ones(4), y)
    with pytest.raises(ValueError, match="toy"):
        prog(x)
