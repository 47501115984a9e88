"""The port's multifrontal LU (lu/multifrontal.py) against the JAX
reference on the CPU in float64: the same seeded matrices go through
umf_symbolic / umf_numeric / umf_solve / umf_lunz / umf_determinant of
both packages.  Plans and permutations are identical (the host code is
the reference's); factors, solves and determinants agree within 1e-12.
Both LUs run LAPACK getrf on the CPU, so the block pivots are identical
too."""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.lu as ref_lu
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC

from suitesparse_tpu_torch.io.generators import cd3d
import suitesparse_tpu_torch.lu as port_lu
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import Status
from suitesparse_tpu_torch.io import generators

TOL = 1e-12
FACTOR_SYSTEMS = ("L", "Pt_L", "Lt", "Lat", "Lt_P", "Lat_P", "U", "U_Qt",
                  "Ut", "Uat", "Ut_Q", "Uat_Q")


def btf_matrix(seed=4):
    """Block upper triangular: singletons and three irreducible blocks
    coupled above the diagonal (the singletons/BTF path with inner
    multifrontal blocks)."""
    rng = np.random.default_rng(seed)
    sizes = (1, 30, 1, 1, 25, 40, 1)
    n = sum(sizes)
    M = sp.random(n, n, density=0.03, random_state=rng).tolil()
    M = sp.triu(M, 1).tolil()
    lo = 0
    for s in sizes:
        if s > 1:
            blk = sp.random(s, s, density=0.15, random_state=rng).toarray()
            blk += np.roll(np.eye(s), 1, axis=1) + 3.0 * np.eye(s)
            M[lo:lo + s, lo:lo + s] = blk
        else:
            M[lo, lo] = 2.0 + rng.random()
        lo += s
    p = rng.permutation(n)
    q = rng.permutation(n)
    return PortCSC.from_scipy(sp.csc_matrix(M.tocsc()[p][:, q]))


def complex_matrix(n=100, seed=35):
    rng = np.random.default_rng(seed)
    Sr = sp.random(n, n, density=0.05, random_state=rng, format="csc")
    Si = sp.random(n, n, density=0.05, random_state=rng, format="csc")
    S = (Sr + 1j * Si + sp.diags(np.full(n, 4.0 + 1.0j))).tocsc()
    return PortCSC.from_scipy(S)


# name -> (matrix, Common.lu options, systems beyond A/At/Aat)
CASES = {
    "random_unsym": (lambda: generators.random_unsym(250, 0.02, seed=1),
                     {}, ()),
    "circuit_like": (lambda: generators.circuit_like(200, seed=2), {},
                     FACTOR_SYSTEMS),
    "cd3d_6": (lambda: cd3d(6), {}, ("L", "U", "Lt", "Ut")),
    "unsymmetric": (lambda: generators.random_unsym(200, 0.05, seed=3),
                    dict(singletons=False), FACTOR_SYSTEMS),
    "btf": (btf_matrix, {}, ()),
    "complex": (complex_matrix, dict(singletons=False),
                ("Lt", "Lat", "Ut", "Uat")),
}


def _commons(opts):
    rc, pc = ref_common(), port_common()
    for k, v in opts.items():
        setattr(rc.lu, k, v)
        setattr(pc.lu, k, v)
    return rc, pc


@functools.lru_cache(maxsize=None)
def _case(name):
    """(ref A, port A, ref symbolic, port symbolic, ref numeric, port
    numeric), computed once per case."""
    make, opts, _ = CASES[name]
    Ap = make()
    Ar = RefCSC(Ap.indptr, Ap.indices, Ap.data, Ap.shape)
    rc, pc = _commons(opts)
    Sr, Sp = ref_lu.umf_symbolic(Ar, rc), port_lu.umf_symbolic(Ap, pc)
    nr = ref_lu.umf_numeric(Ar, Sr, rc)
    np_ = port_lu.umf_numeric(Ap, Sp, pc, device="cpu")
    return Ar, Ap, Sr, Sp, nr, np_


def _same_symbolic(Sr, Sp):
    assert (Sr.n, Sr.strategy, Sr.nzdiag) == (Sp.n, Sp.strategy, Sp.nzdiag)
    assert Sr.sym_ratio == Sp.sym_ratio
    if Sr.singles is not None:
        for k in ("p", "q", "r"):
            assert np.array_equal(getattr(Sr.singles, k),
                                  getattr(Sp.singles, k)), k
        assert len(Sr.singles.subs) == len(Sp.singles.subs)
        for a, b in zip(Sr.singles.subs, Sp.singles.subs):
            assert (a is None) == (b is None)
            if a is not None:
                _same_symbolic(a[0], b[0])
        return
    assert Sp.singles is None
    for k in ("a_scatter_L", "a_scatter_U", "a_perm_rows", "a_perm_cols",
              "rowmatch"):
        assert np.array_equal(getattr(Sr, k), getattr(Sp, k)), k
    assert Sr.plan.total == Sp.plan.total and Sr.plan.meta == Sp.plan.meta


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same_numeric(nr, np_):
    assert nr.singular == np_.singular
    assert np.array_equal(nr.Rs, np_.Rs)
    if nr.bnums is not None:
        assert np_.bnums is not None and len(nr.bnums) == len(np_.bnums)
        for a, b in zip(nr.bnums, np_.bnums):
            assert (a is None) == (b is None)
            if a is not None:
                _same_numeric(a, b)
        return
    assert np.array_equal(nr.Cs, np_.Cs)
    assert np_.Lb.dtype == torch.from_numpy(np.array(nr.Lb)).dtype
    assert _rel(np_.Lb.numpy(), nr.Lb) <= TOL
    assert _rel(np_.Ub.numpy(), nr.Ub) <= TOL
    for lr, lp in zip(nr.pivs, np_.pivs, strict=True):
        for pr, pp in zip(lr, lp, strict=True):
            assert np.array_equal(np.asarray(pr), pp.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_symbolic_is_the_reference(name):
    _, _, Sr, Sp, _, _ = _case(name)
    _same_symbolic(Sr, Sp)


@pytest.mark.parametrize("name", list(CASES))
def test_numeric_matches_reference(name):
    _, _, _, _, nr, np_ = _case(name)
    assert np_.ok
    _same_numeric(nr, np_)


@pytest.mark.parametrize("name", list(CASES))
def test_every_system_matches_reference(name):
    Ar, Ap, _, _, nr, np_ = _case(name)
    n = Ap.ncol
    rng = np.random.default_rng(11)
    cplx = np.iscomplexobj(Ap.data)
    b1 = rng.standard_normal(n) + (1j * rng.standard_normal(n) if cplx
                                   else 0.0)
    bk = rng.standard_normal((n, 3))
    for system in ("A", "At", "Aat"):
        # refined (A given) with 3 right-hand sides, and one raw solve
        for b, kw in ((bk, dict(A=Ar)), (b1, dict(refine=0))):
            xr = ref_lu.umf_solve(nr, b, system, **kw)
            xp = port_lu.umf_solve(np_, b, system,
                                   **{k: Ap if k == "A" else v
                                      for k, v in kw.items()})
            assert xp.shape == b.shape and xp.dtype == xr.dtype
            assert _rel(xp, xr) <= TOL, system
    for system in CASES[name][2]:
        xr = ref_lu.umf_solve(nr, bk, system)
        assert _rel(port_lu.umf_solve(np_, bk, system), xr) <= TOL, system


@pytest.mark.parametrize("name", list(CASES))
def test_lunz_and_determinant_match_reference(name):
    _, _, _, _, nr, np_ = _case(name)
    assert port_lu.umf_lunz(np_) == ref_lu.umf_lunz(nr)
    (mr, er), (mp, ep) = ref_lu.umf_determinant(nr), \
        port_lu.umf_determinant(np_)
    assert ep == er
    assert abs(mp - mr) <= TOL * abs(mr)
    assert type(mp) is type(mr)


def _zero_row(stored: bool):
    """cd3d_5 with row 60's values zero: kept as stored zeros, or dropped
    from the pattern."""
    A = cd3d(5)
    data = A.data.copy()
    data[A.indices == 60] = 0.0
    S = sp.csc_matrix((data, A.indices, A.indptr), shape=A.shape)
    if not stored:
        S.eliminate_zeros()
    return PortCSC.from_scipy(S)


def test_singular_verdict_matches_reference():
    """A zero row that reaches the device numeric (no singleton path):
    both packages flag it, with status SINGULAR."""
    Ap = _zero_row(stored=False)
    Ar = RefCSC(Ap.indptr, Ap.indices, Ap.data, Ap.shape)
    rc, pc = _commons(dict(singletons=False))
    nr = ref_lu.umf_numeric(Ar, ref_lu.umf_symbolic(Ar, rc), rc)
    np_ = port_lu.umf_numeric(Ap, port_lu.umf_symbolic(Ap, pc), pc,
                              device="cpu")
    assert nr.singular and np_.singular
    assert pc.status == Status.SINGULAR and rc.status.name == "SINGULAR"


def test_stored_zero_row_is_flagged_singular():
    """The zero row as explicit stored zeros, as chip_smoke.py builds it:
    the values keep their slots, so the numeric sees the zero row."""
    A = _zero_row(stored=True)
    assert A.nnz == cd3d(5).nnz
    cm = port_common()
    cm.lu.singletons = False
    num = port_lu.umf_numeric(A, port_lu.umf_symbolic(A, cm), cm,
                              device="cpu")
    assert num.singular and cm.status == Status.SINGULAR


def test_stored_zeros_keep_their_slots():
    """Stored zeros are pattern entries: the scaled values are assembled
    into the symbolic's slots one for one (a sparse product that dropped
    them would shift every later value)."""
    A = cd3d(5)
    cols = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    data = A.data.copy()
    data[np.nonzero(A.indices != cols)[0][::7]] = 0.0
    Az = PortCSC(A.indptr, A.indices, data, A.shape)
    S = Az.to_scipy().copy()
    S.eliminate_zeros()
    Ad = PortCSC.from_scipy(S)
    b = np.random.default_rng(5).standard_normal(A.ncol)
    xs = []
    for M, opts in ((Az, dict(singletons=False)),
                    (Az, dict(singletons=False, strategy="unsymmetric")),
                    (Ad, dict(singletons=False))):
        _, cm = _commons(opts)
        num = port_lu.umf_numeric(M, port_lu.umf_symbolic(M, cm), cm,
                                  device="cpu")
        x = port_lu.umf_solve(num, b, refine=0)
        assert np.abs(S @ x - b).max() <= 1e-12 * np.abs(b).max()
        xs.append(x)
    assert _rel(xs[0], xs[2]) <= TOL and _rel(xs[1], xs[2]) <= 1e-10


def test_cpu_factor_dtypes_and_device():
    """float64 / complex128 on the CPU by default; float32 on request."""
    _, _, _, _, _, np_ = _case("unsymmetric")
    assert np_.Lb.dtype == torch.float64 and np_.Lb.device.type == "cpu"
    _, _, _, _, _, nc = _case("complex")
    assert nc.Lb.dtype == torch.complex128
    Ar, Ap, _, Sp, _, _ = _case("unsymmetric")
    cm = port_common()
    cm.lu.singletons = False
    n32 = port_lu.umf_numeric(Ap, Sp, cm, dtype=np.float32, device="cpu")
    assert n32.Lb.dtype == torch.float32 and n32.ok
    b = np.ones(Ap.ncol)
    x = port_lu.umf_solve(n32, b, A=Ap, refine=3)
    assert np.abs(Ap.to_scipy() @ x - b).max() < 1e-12
