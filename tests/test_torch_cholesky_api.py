"""The port's CHOLMOD front end (cholesky/api.py, simplicial.py) against
the JAX reference on the CPU, f64, seeded io.generators matrices:
cholesky in each mode, CholeskySolver refactorize + every solve system,
spsolve_chol with refinement, the simplicial Factor arrays, rcond, the
supernodal -> simplicial conversion and a complex Hermitian matrix.

Tolerances: symbolic arrays and the simplicial pattern identical (the
same host code); factors 1e-13 and solves 1e-12 relative."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SYM_UPPER as REF_UPPER
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SYM_UPPER as PORT_UPPER
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.io import generators as port_gen

REF = (ref_chol, ref_gen, ref_common, RefCSC, {})
PORT = (port_chol, port_gen, port_common, PortCSC, {"device": "cpu"})


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _solver(pkg, gen, arg, mode=None, **kw):
    chol, gens, common, _, dev = pkg
    A = getattr(gens, gen)(arg)
    return A, chol.cholesky(A, common(), mode=mode, **dev, **kw)


def _same_simplicial(fr, fp):
    assert fp.n == fr.n and fp.is_ll == fr.is_ll and fp.minor == fr.minor
    for name in ("perm", "Lp", "Li"):
        assert np.array_equal(getattr(fp, name), getattr(fr, name)), name
    assert _rel(fp.Lx, fr.Lx) <= 1e-13
    if fr.D is None:
        assert fp.D is None
    else:
        assert _rel(fp.D, fr.D) <= 1e-13


@pytest.mark.parametrize("mode,gen,arg", [
    ("simplicial", "random_spd", 120),
    ("supernodal", "laplacian_3d", 8),
    ("auto", "laplacian_2d", 10),
    ("auto", "laplacian_3d", 9),
])
def test_cholesky_modes_match_reference(mode, gen, arg):
    (Ar, sr), (Ap, sp_) = (_solver(REF, gen, arg, mode),
                           _solver(PORT, gen, arg, mode))
    assert sp_.sym.is_super == sr.sym.is_super
    for name in ("perm", "parent", "post", "colcount"):
        assert np.array_equal(getattr(sp_.sym, name), getattr(sr.sym, name))
    assert (sp_.sym.lnz, sp_.sym.flops) == (sr.sym.lnz, sr.sym.flops)
    if sr.sym.is_super:
        assert isinstance(sp_.factor, port_chol.SuperFactor)
        assert sp_.factor.Lx.dtype == torch.float64
        tot = sr.factor.plan.total
        assert _rel(sp_.factor.Lx.numpy()[:tot],
                    np.asarray(sr.factor.Lx)[:tot]) <= 1e-13
    else:
        _same_simplicial(sr.factor, sp_.factor)
    b = np.random.default_rng(arg).standard_normal(Ar.ncol)
    xr, xp = sr.solve(b), sp_.solve(b)
    assert _rel(xp, xr) <= 1e-12
    assert port_chol.residual_norm(Ap, xp, b) < 1e-13


SIMPLICIAL_SYSTEMS = ["A", "LDLt", "LD", "DLt", "L", "Lt", "D", "P", "Pt"]
SUPER_SYSTEMS = ["A", "LLt", "L", "Lt", "P", "Pt"]


@pytest.mark.parametrize("mode,system", [("simplicial", s)
                                         for s in SIMPLICIAL_SYSTEMS]
                         + [("supernodal", s) for s in SUPER_SYSTEMS])
def test_solver_refactorize_and_systems_match_reference(mode, system):
    """CholeskySolver: analyze once, refactorize twice with new values
    (LDL' on the simplicial path, as ll=False asks), solve every system
    the factor has, one and three right-hand sides."""
    rng = np.random.default_rng(11)
    n = 7 ** 3
    rhs = (rng.standard_normal(n), rng.standard_normal((n, 3)))
    outs = []
    for chol, gens, common, csc, dev in (REF, PORT):
        cm = common()
        cm.cholesky.supernodal = mode
        A = gens.laplacian_3d(7)
        sym = chol.analyze(A, cm)
        solver = chol.CholeskySolver(sym=sym, common=cm, **dev)
        got = []
        for scale in (1.0, 2.5):
            A2 = csc(A.indptr, A.indices, A.data * scale, A.shape,
                     stype=A.stype)
            solver.refactorize(A2, ll=False)
            assert sym.is_super == (mode == "supernodal")
            got += [solver.solve(b, system) for b in rhs]
        outs.append(got)
    for xr, xp in zip(*outs):
        assert xp.shape == xr.shape
        assert _rel(xp, xr) <= 1e-12


@pytest.mark.parametrize("dtype,steps", [(np.float64, 0), (np.float32, 3)])
def test_spsolve_chol_matches_reference(dtype, steps):
    """spsolve_chol with a float64 factor, and with a float32 factor and
    3 float64 refinement steps on the host, which recovers the float64
    residual; after refinement both packages agree to 1e-12."""
    xs = []
    for chol, gens, common, _, dev in (REF, PORT):
        A = gens.laplacian_2d(14)
        cm = common()
        cm.cholesky.supernodal = "supernodal"
        b = np.random.default_rng(7).standard_normal(A.ncol)
        x = chol.spsolve_chol(A, b, cm, dtype=dtype, refine_steps=steps,
                              **dev)
        assert x.dtype == np.float64
        assert chol.residual_norm(A, x, b) < 1e-13
        xs.append(x)
    assert _rel(xs[1], xs[0]) <= 1e-12


@pytest.mark.parametrize("ll", [False, True])
def test_simplicial_factor_and_rcond_match_reference(ll):
    fs = []
    for chol, gens, common, _, _ in (REF, PORT):
        A = gens.random_spd(150, 0.03, seed=3)
        f = chol.factorize_simplicial(A, ll=ll)
        assert f.ok
        fs.append((f, chol.rcond(f), f.logdet()))
    (fr, rr, lr), (fp, rp, lp) = fs
    _same_simplicial(fr, fp)
    assert abs(rp - rr) <= 1e-13 * rr and abs(lp - lr) <= 1e-13 * abs(lr)


def test_rowfac_matches_reference():
    """alloc_factor + two rowfac passes, and rowfac_mask."""
    outs = []
    for chol, gens, _, _, _ in (REF, PORT):
        A = gens.random_spd(60, 0.08, seed=5)
        f = chol.rowfac(A, chol.rowfac(A, chol.alloc_factor(A), 0, 25),
                        25, 60)
        mask = np.zeros(60, dtype=bool)
        mask[[3, 17, 29]] = True
        g = chol.rowfac_mask(A, chol.alloc_factor(A), 0, 60, mask)
        outs.append((f, g))
    for fr, fp in zip(*outs):
        _same_simplicial(fr, fp)


def test_supernodal_to_simplicial_matches_reference():
    Ls = []
    for chol, gens, common, _, dev in (REF, PORT):
        A = gens.laplacian_3d(7)
        s = chol.cholesky(A, common(), mode="supernodal", **dev)
        Ls.append(s.factor.to_simplicial())
    _same_simplicial(*Ls)
    L = Ls[1].L_scipy().toarray()
    D = port_gen.laplacian_3d(7).to_scipy().toarray()
    P = D[np.ix_(Ls[1].perm, Ls[1].perm)]
    assert np.abs(L @ L.T - P).max() < 1e-12


def _hermitian(csc, upper, n=40, seed=1):
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=0.1, random_state=rng, format="csc")
    B = B + 1j * sp.random(n, n, density=0.1, random_state=rng, format="csc")
    H = (B @ B.conj().T + n * sp.identity(n)).tocsc()
    U = sp.triu(H).tocsc()
    return H, csc(U.indptr, U.indices, U.data, U.shape, stype=upper)


def test_complex_hermitian_takes_the_simplicial_path():
    """A complex matrix under a supernodal configuration goes to the host
    simplicial code in both packages (the supernodal programs are
    real-only)."""
    outs = []
    rng = np.random.default_rng(2)
    b = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    for (chol, _, common, csc, dev), upper in ((REF, REF_UPPER),
                                               (PORT, PORT_UPPER)):
        H, A = _hermitian(csc, upper)
        cm = common()
        s = chol.cholesky(A, cm, mode="supernodal", **dev)
        assert isinstance(s.factor, chol.Factor)
        x = s.solve(b)
        assert np.abs(H @ x - b).max() < 1e-12
        outs.append((s.factor, x))
    _same_simplicial(outs[0][0], outs[1][0])
    assert _rel(outs[1][1], outs[0][1]) <= 1e-12
    cm = port_common()
    cm.cholesky.supernodal = "supernodal"
    sym = port_chol.analyze(A, cm)
    ss = port_chol.super_symbolic(A, sym, cm)
    with pytest.raises(TypeError, match="real-only"):
        port_chol.factorize_super(A, sym, ss, common=cm, device="cpu")
