"""The port's Cholesky extras (cholesky/extra.py) and the LDL layer
(models/ldl.py) against the JAX reference on the CPU: spsolve with a
sparse right-hand side, solve2 subset solves, resymbol, lsolve_pattern,
row_subtree and every ldl_* name.  The same host code runs in both, so
patterns are identical and values agree to 1e-12 relative."""
import numpy as np
import pytest
import scipy.sparse as sp

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.io import generators as ref_gen
from suitesparse_tpu.models import ldl as ref_ldl

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.io import generators as port_gen
from suitesparse_tpu_torch.models import ldl as port_ldl

PKGS = ((ref_chol, ref_gen, RefCSC, ref_ldl),
        (port_chol, port_gen, PortCSC, port_ldl))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _both(fn):
    return [fn(*pkg) for pkg in PKGS]


def _rhs(n, k, seed):
    return sp.random(n, k, density=0.2, random_state=np.random.default_rng(seed),
                     format="csc")


@pytest.mark.parametrize("system", ["A", "LDLt", "L", "Lt"])
def test_spsolve_sparse_rhs_matches_reference(system):
    B = _rhs(30, 3, 10)

    def run(chol, gens, csc, _):
        A = gens.random_spd(30, 0.15, seed=9)
        X = chol.spsolve(chol.factorize_simplicial(A), csc.from_scipy(B),
                         system)
        if system == "A":
            assert np.abs(A.to_scipy() @ X.to_scipy().toarray()
                          - B.toarray()).max() < 1e-10
        return X

    Xr, Xp = _both(run)
    assert np.array_equal(Xp.indptr, Xr.indptr)
    assert np.array_equal(Xp.indices, Xr.indices)
    assert _rel(Xp.data, Xr.data) <= 1e-12


@pytest.mark.parametrize("ll", [False, True])
def test_solve2_subset_matches_reference(ll):
    b = np.zeros(40)
    bset = np.array([3, 17, 25])
    b[bset] = [1.0, -2.0, 0.5]

    def run(chol, gens, csc, _):
        f = chol.factorize_simplicial(gens.random_spd(40, 0.1, seed=11),
                                      ll=ll)
        x_sub, xset = chol.solve2(f, b, bset)
        x_full = chol.solve(f, b)
        assert np.allclose(x_sub, x_full, atol=1e-12)
        x_plain, none = chol.solve2(f, b)
        assert none is None and np.array_equal(x_plain, x_full)
        return x_sub, xset

    (xr, sr), (xp, sp_) = _both(run)
    assert np.array_equal(sp_, sr)
    assert _rel(xp, xr) <= 1e-12


def test_lsolve_pattern_and_row_subtree_match_reference():
    B = _rhs(20, 2, 13)

    def run(chol, gens, csc, _):
        A = gens.random_spd(20, 0.15, seed=12)
        f = chol.factorize_simplicial(A)
        Bs = csc.from_scipy(B)
        patts = [chol.lsolve_pattern(f, Bs, k) for k in range(2)]
        b = B.toarray()[:, 0]
        y = chol.lsolve(f, b[f.perm])
        assert set(np.nonzero(y)[0]) <= set(patts[0].tolist())
        P = chol.simplicial._permuted_upper(A, f.perm)
        subtrees = [np.sort(chol.row_subtree(P, k, f.symbolic.parent))
                    for k in range(20)]
        return patts, subtrees

    (pr, tr), (pp, tp) = _both(run)
    for a, b in zip(pr + tr, pp + tp):
        assert np.array_equal(b, a)


def test_resymbol_matches_reference():
    def run(chol, gens, csc, _):
        A = gens.random_spd(25, 0.2, seed=14)
        f = chol.factorize_simplicial(A)
        A2 = A.drop(0.05)
        f2 = chol.resymbol(A2, f)
        b = np.ones(25)
        x = chol.solve(f2, b)
        assert np.abs(A2.to_scipy().toarray() @ x - b).max() < 1e-8
        return f2, x

    (fr, xr), (fp, xp) = _both(run)
    for name in ("perm", "Lp", "Li"):
        assert np.array_equal(getattr(fp, name), getattr(fr, name))
    assert _rel(fp.Lx, fr.Lx) <= 1e-12 and _rel(xp, xr) <= 1e-12


def test_ldl_layer_matches_reference():
    b = np.random.default_rng(15).standard_normal(50)

    def run(chol, gens, csc, ldl):
        A = gens.random_spd(50, 0.08, seed=16)
        assert ldl.ldl_valid_matrix(A)
        sym = ldl.ldl_symbolic(A)
        assert not sym.is_super
        f = ldl.ldl_numeric(A, sym)
        assert ldl.ldl_valid_perm(50, f.perm)
        assert not ldl.ldl_valid_perm(50, np.zeros(50, dtype=int))
        y = ldl.ldl_perm(f.perm, b)
        y = ldl.ldl_ltsolve(f, ldl.ldl_dsolve(f, ldl.ldl_lsolve(f, y)))
        x = ldl.ldl_permt(f.perm, y)
        assert chol.residual_norm(A, x, b) < 1e-13
        return f, x

    (fr, xr), (fp, xp) = _both(run)
    for name in ("perm", "Lp", "Li"):
        assert np.array_equal(getattr(fp, name), getattr(fr, name))
    assert _rel(fp.Lx, fr.Lx) <= 1e-12 and _rel(fp.D, fr.D) <= 1e-12
    assert _rel(xp, xr) <= 1e-12
