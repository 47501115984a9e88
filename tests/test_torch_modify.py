"""The port's CHOLMOD/Modify (cholesky/modify.py) against the JAX reference
on the CPU, mirroring tests/test_modify.py: rank-1 and rank-k update and
downdate, updown_solve, rowdel/rowadd round trips and the error paths.

The two packages run the same host code, so the modified factors must
agree: pattern identical, values and D to 1e-13 relative, solves to
1e-12; each also meets the reference's residual bar against a fresh
matrix."""
import numpy as np
import pytest
import scipy.sparse as sp

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.core.status import SparseError as RefError
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import SparseError as PortError
from suitesparse_tpu_torch.io import generators as port_gen

PKGS = ((ref_chol, ref_gen, RefCSC), (port_chol, port_gen, PortCSC))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _same(fr, fp):
    for name in ("perm", "Lp", "Li"):
        assert np.array_equal(getattr(fp, name), getattr(fr, name)), name
    assert _rel(fp.Lx, fr.Lx) <= 1e-13 and _rel(fp.D, fr.D) <= 1e-13
    assert fp.minor == fr.minor and not fp.is_ll


def _both(fn):
    """fn(chol, gens, csc) for each package; returns both results."""
    return [fn(*pkg) for pkg in PKGS]


@pytest.mark.parametrize("k,update", [(1, True), (3, True), (1, False),
                                      (3, False)])
def test_updown_matches_reference(k, update):
    """Rank-k update, and rank-k downdate of a matrix first updated by the
    same C (so the downdate stays positive definite)."""
    C = sp.random(50, k, density=0.15, random_state=np.random.default_rng(k),
                  format="csc")
    b = np.random.default_rng(10 + k).standard_normal(50)

    def run(chol, gens, csc):
        A = gens.random_spd(50, 0.08, seed=0)
        Cs = csc.from_scipy(C)
        if update:
            f = chol.updown(chol.factorize_simplicial(A), Cs, update=True)
            A2 = csc.from_scipy((A.to_scipy() + C @ C.T).tocsc())
        else:
            A2 = A
            Au = csc.from_scipy((A.to_scipy() + C @ C.T).tocsc())
            f = chol.updown(chol.factorize_simplicial(Au), Cs, update=False)
        x = chol.solve(f, b)
        assert chol.residual_norm(A2, x, b) < 1e-12
        return f, x

    (fr, xr), (fp, xp) = _both(run)
    _same(fr, fp)
    assert _rel(xp, xr) <= 1e-12


def test_update_then_downdate_is_identity():
    def run(chol, gens, csc):
        A = gens.random_spd(40, 0.1, seed=2)
        C = csc.from_scipy(sp.random(40, 2, density=0.2,
                                     random_state=np.random.default_rng(3),
                                     format="csc"))
        f = chol.updown(chol.updown(chol.factorize_simplicial(A), C, True),
                        C, False)
        b = np.ones(40)
        assert chol.residual_norm(A, chol.solve(f, b), b) < 1e-12
        return f

    _same(*_both(run))


def test_updown_solve_matches_reference():
    C = sp.random(30, 1, density=0.3, random_state=np.random.default_rng(6),
                  format="csc")
    b = np.arange(30, dtype=float)

    def run(chol, gens, csc):
        A = gens.random_spd(30, 0.15, seed=5)
        f, x = chol.updown_solve(chol.factorize_simplicial(A),
                                 csc.from_scipy(C), b, update=True)
        A2 = csc.from_scipy((A.to_scipy() + C @ C.T).tocsc())
        assert chol.residual_norm(A2, x, b) < 1e-13
        return f, x

    (fr, xr), (fp, xp) = _both(run)
    _same(fr, fp)
    assert _rel(xp, xr) <= 1e-12


def test_update_grows_the_pattern():
    C = sp.csc_matrix((np.array([1.0, 1.0]), (np.array([2, 27]),
                                              np.array([0, 0]))),
                      shape=(30, 1))

    def run(chol, gens, csc):
        A = csc.from_scipy(sp.diags([4.0] * 30).tocsc())
        f = chol.factorize_simplicial(A)
        f2 = chol.updown(f, csc.from_scipy(C), True)
        assert f2.Lp[-1] > f.Lp[-1]
        return f2

    _same(*_both(run))


def test_rowdel_rowadd_round_trip_matches_reference():
    b = np.random.default_rng(8).standard_normal(40)
    j = 13

    def run(chol, gens, csc):
        A = gens.random_spd(40, 0.1, seed=7)
        fd = chol.rowdel(chol.factorize_simplicial(A), j)
        Ad = A.to_scipy().tolil()
        colj = A.to_scipy()[:, j].toarray().ravel()
        Ad[j, :] = 0
        Ad[:, j] = 0
        Ad[j, j] = 1.0
        xd = chol.solve(fd, b)
        assert chol.residual_norm(csc.from_scipy(Ad.tocsc()), xd, b) < 1e-12
        fa = chol.rowadd(fd, j, csc.from_scipy(sp.csc_matrix(
            colj.reshape(-1, 1))))
        xa = chol.solve(fa, b)
        assert chol.residual_norm(A, xa, b) < 1e-12
        return fd, fa, xd, xa

    (rd, ra, rxd, rxa), (pd, pa, pxd, pxa) = _both(run)
    _same(rd, pd)
    _same(ra, pa)
    assert _rel(pxd, rxd) <= 1e-12 and _rel(pxa, rxa) <= 1e-12


@pytest.mark.parametrize("case", ["downdate_indefinite", "rowadd_shape",
                                  "updown_ll"])
def test_error_paths_match_reference(case):
    for (chol, gens, csc), err in zip(PKGS, (RefError, PortError)):
        if case == "downdate_indefinite":
            A = gens.random_spd(20, 0.2, seed=4)
            C = csc.from_scipy(sp.csc_matrix(100.0 * np.ones((20, 1))))
            with pytest.raises(err):
                chol.updown(chol.factorize_simplicial(A), C, update=False)
        elif case == "rowadd_shape":
            A = gens.random_spd(10, 0.3, seed=9)
            bad = csc.from_scipy(sp.identity(10).tocsc())
            with pytest.raises(err):
                chol.rowadd(chol.factorize_simplicial(A), 0, bad)
        else:
            A = gens.random_spd(10, 0.3, seed=9)
            C = csc.from_scipy(sp.csc_matrix(np.ones((10, 1))))
            with pytest.raises(err, match="LDL"):
                chol.updown(chol.factorize_simplicial(A, ll=True), C)
