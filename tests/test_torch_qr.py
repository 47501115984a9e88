"""The port's multifrontal QR (qr/spqr.py) and spqr_rank utilities against
the JAX reference on the CPU in float64: the same seeded matrices go
through qr_symbolic / qr_factorize / qr_solve / qr_qmult / qr_min2norm and
spqr_* of both packages.  The symbolic objects are identical (the host code
is the reference's); R agrees within 1e-12 relative up to one sign per R
row (both reach LAPACK geqrf here, but through different builds), Q'b with
the same signs; rank and tol are equal; solutions, qr_qmult and spqr_*
agree within 1e-10 (1e-12 where both run on the same factor).  The cases
of tests/test_qr.py are mirrored on the port with their own tolerances."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.models as ref_models
import suitesparse_tpu.qr as ref_qr
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC

from chip_smoke import grad3d as _grad
import suitesparse_tpu_torch.models as port_models
import suitesparse_tpu_torch.qr as port_qr
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import SparseError, Status
from suitesparse_tpu_torch.qr import spqr as port_spqr

CPU = "cpu"
TOL = 1e-12          # same operations on the same inputs, two LAPACK builds
SOL_TOL = 1e-10      # solutions through the R solves


def _rand_tall(m, n, d, seed):
    """tests/test_qr.py's generator: random sparse plus one 0.5 per column
    at a random row (full column rank with high probability)."""
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=d, random_state=rng, format="csc")
    S = S + sp.csc_matrix((np.ones(n) * 0.5,
                           (rng.integers(0, m, n), np.arange(n))),
                          shape=(m, n))
    return S.tocsc()


def _complex_tall(m, n, d, seed):
    rng = np.random.default_rng(seed)
    S = _rand_tall(m, n, d, seed).astype(complex)
    return (S + 1j * sp.random(m, n, density=0.1, random_state=rng,
                               format="csc")).tocsc()


def _pair(S):
    S = sp.csc_matrix(S)
    return RefCSC.from_scipy(S), PortCSC.from_scipy(S)


CASES = {
    "tall": lambda: _rand_tall(70, 45, 0.15, 3),
    "tall_sparse": lambda: _rand_tall(150, 90, 0.06, 1),
    "square": lambda: _rand_tall(80, 80, 0.1, 2),
    "complex": lambda: _complex_tall(50, 30, 0.2, 13),
    "grad3d_4": lambda: _grad(4),
}


def _arrays_equal(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, where
    assert np.array_equal(a, b), where


def _fields_equal(x, y, where, skip=()):
    for f in dataclasses.fields(x):
        if f.name in skip or f.name.startswith("_"):
            continue
        a, b = getattr(x, f.name), getattr(y, f.name)
        if isinstance(a, np.ndarray):
            _arrays_equal(a, b, f"{where}.{f.name}")
        elif isinstance(a, (int, float, str, bool, tuple)) or a is None:
            assert a == b, f"{where}.{f.name}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_symbolic_identical_to_reference(name):
    S = CASES[name]()
    Ar, Ap = _pair(S)
    Sr = ref_qr.qr_symbolic(Ar, ref_common())
    Sp = port_qr.qr_symbolic(Ap, port_common())
    _fields_equal(Sr, Sp, "QRSymbolic", skip=("sym", "ss", "levels"))
    _fields_equal(Sr.sym, Sp.sym, "sym", skip=("supernodes",))
    _fields_equal(Sr.ss, Sp.ss, "ss")
    assert len(Sr.arow_of_front) == len(Sp.arow_of_front)
    for k, (a, b) in enumerate(zip(Sr.arow_of_front, Sp.arow_of_front)):
        _arrays_equal(a, b, f"arow_of_front[{k}]")
    assert [len(lv) for lv in Sr.levels] == [len(lv) for lv in Sp.levels]
    for li, (lr, lp) in enumerate(zip(Sr.levels, Sp.levels)):
        for bi, (br, bp) in enumerate(zip(lr, lp)):
            _fields_equal(br, bp, f"levels[{li}][{bi}]")
            # the cached sorted maps too
            for key, src, dst in (("_a_maps", "a_src", "a_dst"),
                                  ("_c_maps", "c_src", "c_dst")):
                if len(getattr(br, src)):
                    mr = ref_qr.spqr._sorted_pair(br, key, getattr(br, src),
                                                  getattr(br, dst))
                    mp = port_spqr._sorted_pair(bp, key, getattr(bp, src),
                                                getattr(bp, dst))
                    _arrays_equal(mr[0], mp[0], f"{key} src")
                    _arrays_equal(mr[1], mp[1], f"{key} dst")


def _row_of_flat(S):
    """R's row (the permuted column j) of each position of the flat panel
    buffer; -1 for padding and the trash slot."""
    ss = S.ss
    rows = np.full(S.total_R + 1, -1, dtype=np.int64)
    for s in range(ss.nsuper):
        ms, ns = ss.panel_shape(s)
        Np, Mp = int(ss.panel_Np[s]), int(ss.panel_Mp[s])
        o = int(ss.panel_off[s])
        t = np.arange(Np)
        blk = np.where(t < ns, int(ss.super[s]) + t, -1)
        rows[o:o + Mp * Np] = np.tile(blk, Mp)
    return rows


def _ref_diag(S, h):
    """The reference's readout of R's diagonal (qr_factorize, spqr.py
    :407-417)."""
    ss = S.ss
    diag = np.zeros(S.n, dtype=np.result_type(h.dtype, np.float64))
    for s in range(ss.nsuper):
        ms, ns_ = ss.panel_shape(s)
        Np, Mp = int(ss.panel_Np[s]), int(ss.panel_Mp[s])
        o = int(ss.panel_off[s])
        pn = h[o:o + Mp * Np].reshape(Mp, Np)
        j1 = int(ss.super[s])
        diag[j1:j1 + ns_] = np.diag(pn[:ns_, :ns_])
    return diag


def _signs(S, h):
    d = _ref_diag(S, h)
    sg = np.where(d == 0, 1.0, d / np.abs(np.where(d == 0, 1.0, d)))
    return sg


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", sorted(CASES))
def test_factor_matches_reference_up_to_row_signs(name):
    S = CASES[name]()
    if name == "grad3d_4":      # full column rank: the Tikhonov form
        S = sp.vstack([S, 2.0 * sp.identity(S.shape[1])]).tocsc()
    Ar, Ap = _pair(S)
    m = S.shape[0]
    b = np.random.default_rng(5).standard_normal((m, 2))
    if np.iscomplexobj(S.data):
        b = b + 1j * np.random.default_rng(6).standard_normal((m, 2))
    Sr = ref_qr.qr_symbolic(Ar, ref_common())
    Sp = port_qr.qr_symbolic(Ap, port_common())
    cr, cp = ref_common(), port_common()
    nr = ref_qr.qr_factorize(Ar, Sr, b=b, common=cr)
    np_ = port_qr.qr_factorize(Ap, Sp, b=b, common=cp, device=CPU)
    hr = np.asarray(nr.Rbuf)
    hp = np_.Rbuf.numpy()
    assert hp.dtype == hr.dtype
    rows = _row_of_flat(Sp)
    sr, sp_ = _signs(Sr, hr), _signs(Sp, hp)
    live = rows >= 0
    Rr = hr[live] * np.conj(sr[rows[live]])
    Rp = hp[live] * np.conj(sp_[rows[live]])
    assert _rel(Rp, Rr) <= TOL
    assert np.all(hp[~live] == 0) and np.all(hr[~live] == 0)
    # Q'b's top rows carry the same row signs
    assert _rel(np_.qtb * np.conj(sp_)[:, None],
                nr.qtb * np.conj(sr)[:, None]) <= TOL
    assert np_.rank == nr.rank == min(S.shape)
    assert np_.tol == nr.tol
    assert cp.info["qr_rank"] == cr.info["qr_rank"]
    assert cp.status == Status.OK


def test_rank_deficient_factor_rank_and_tol_equal():
    """grad3d_4 (rank n - 1): the same rank and tol; R's live rows agree up
    to sign on every column but the dead one."""
    Ar, Ap = _pair(_grad(4))
    Sr = ref_qr.qr_symbolic(Ar, ref_common())
    Sp = port_qr.qr_symbolic(Ap, port_common())
    nr = ref_qr.qr_factorize(Ar, Sr)
    cp = port_common()
    np_ = port_qr.qr_factorize(Ap, Sp, common=cp, device=CPU)
    assert np_.rank == nr.rank == Ap.ncol - 1
    assert np_.tol == nr.tol
    assert cp.status == Status.SINGULAR
    dr = np.abs(_ref_diag(Sr, np.asarray(nr.Rbuf)))
    dp = np.abs(port_qr.r_diagonal(Sp, np_.Rbuf))
    live = dr > nr.tol
    assert _rel(dp[live], dr[live]) <= TOL


@pytest.mark.parametrize("shape", [(3, 40, 24), (5, 16, 32), (2, 8, 8),
                                   (4, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128])
def test_r_mode_is_bit_identical_to_reduced(shape, dtype):
    """mode="r" (used when neither b nor keep_q is asked) returns the same
    geqrf R as the reduced mode, bit for bit, tall and wide fronts."""
    g = torch.Generator().manual_seed(sum(shape))
    F = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    if dtype.is_complex:
        F = F + 1j * torch.randn(shape, generator=g, dtype=torch.float64)
    _, Rred = torch.linalg.qr(F, mode="reduced")
    Qr, Rr = torch.linalg.qr(F, mode="r")
    assert Qr.numel() == 0
    assert torch.equal(Rr, Rred)


@pytest.mark.parametrize("name", ["tall", "square", "complex"])
def test_factor_without_b_is_bit_identical_to_factor_with_b(name):
    """The port's shortcut: the R buffer of a factorization without b
    (mode "r", no Q) equals the one with b (mode "reduced") bit for bit."""
    Ap = PortCSC.from_scipy(CASES[name]())
    Sp = port_qr.qr_symbolic(Ap, port_common())
    with_b = port_qr.qr_factorize(Ap, Sp, b=np.ones(Ap.nrow), device=CPU)
    without = port_qr.qr_factorize(Ap, Sp, device=CPU)
    assert torch.equal(with_b.Rbuf, without.Rbuf)
    assert without.rank == with_b.rank
    assert np.all(without.qtb == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_diagonal_gather_equals_reference_readout(name):
    Ap = PortCSC.from_scipy(CASES[name]())
    Sp = port_qr.qr_symbolic(Ap, port_common())
    num = port_qr.qr_factorize(Ap, Sp, device=CPU)
    got = port_qr.r_diagonal(Sp, num.Rbuf)
    want = _ref_diag(Sp, num.Rbuf.numpy())
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_refactor_is_bit_identical():
    Ap = PortCSC.from_scipy(_rand_tall(150, 90, 0.06, 1))
    Sp = port_qr.qr_symbolic(Ap, port_common())
    b = np.arange(150.0)
    a = port_qr.qr_factorize(Ap, Sp, b=b, device=CPU)
    c = port_qr.qr_factorize(Ap, Sp, b=b, device=CPU)
    assert torch.equal(a.Rbuf, c.Rbuf) and np.array_equal(a.qtb, c.qtb)


@pytest.mark.parametrize("name", ["tall", "complex", "grad3d_4"])
def test_numeric_from_numpy_runs_port_solves_on_reference_factor(name):
    """qr_numeric_from_numpy on the reference's factor (keep_q): the port's
    qr_rsolve, qr_rtsolve and all four qr_qmult methods give the
    reference's results within 1e-12."""
    S = CASES[name]()
    Ar, Ap = _pair(S)
    m, n = S.shape
    rng = np.random.default_rng(21)
    b = rng.standard_normal(m)
    Sr = ref_qr.qr_symbolic(Ar, ref_common())
    Sp = port_qr.qr_symbolic(Ap, port_common())
    nr = ref_qr.qr_factorize(Ar, Sr, b=b, keep_q=True)
    got = port_qr.qr_numeric_from_numpy(Sp, np.asarray(nr.Rbuf), nr.qtb,
                                        nr.rank, nr.tol, nr.Qs, device=CPU)
    assert got.Rbuf.device.type == "cpu" and got.rank == nr.rank
    c = rng.standard_normal((n, 2))
    assert _rel(port_qr.qr_rsolve(got, c), ref_qr.qr_rsolve(nr, c)) <= TOL
    assert _rel(port_qr.qr_rtsolve(got, c),
                ref_qr.qr_rtsolve(nr, c)) <= TOL
    assert _rel(port_qr.qr_rsolve(got, got.qtb[:, 0]),
                ref_qr.qr_rsolve(nr, nr.qtb[:, 0])) <= TOL
    n_out = ref_qr.spqr._q_out_layout(Sr)[1]
    X = rng.standard_normal((m, 3))
    Y = rng.standard_normal((n_out, 3))
    for method, arg in (("QTX", X), ("QX", Y), ("XQT", X.T), ("XQ", Y.T)):
        assert _rel(port_qr.qr_qmult(got, arg, method),
                    ref_qr.qr_qmult(nr, arg, method)) <= TOL, method
    with pytest.raises(SparseError):
        port_qr.qr_numeric_from_numpy(Sp, np.zeros(3), nr.qtb, nr.rank,
                                      nr.tol, device=CPU)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_qr.py on the port (plus the reference beside it)
# ---------------------------------------------------------------------------

class TestQR:
    @pytest.mark.parametrize("m,n,d,seed", [(60, 40, 0.2, 0),
                                            (150, 90, 0.06, 1),
                                            (80, 80, 0.1, 2)])
    def test_least_squares_matches_lstsq(self, m, n, d, seed):
        S = _rand_tall(m, n, d, seed)
        Ar, Ap = _pair(S)
        b = np.random.default_rng(seed).standard_normal(m)
        x = port_qr.qr_solve(Ap, b, device=CPU)
        x_ref, *_ = np.linalg.lstsq(S.toarray(), b, rcond=None)
        assert np.linalg.norm(S @ x - b) == pytest.approx(
            np.linalg.norm(S @ x_ref - b), rel=1e-9)
        assert np.abs(x - x_ref).max() < 1e-9
        assert np.abs(x - ref_qr.qr_solve(Ar, b)).max() < SOL_TOL

    def test_r_factor_valid(self):
        """R from the factorization satisfies ||A'A - R'R|| small."""
        S = _rand_tall(70, 45, 0.15, 3)
        A = PortCSC.from_scipy(S)
        Ssym = port_qr.qr_symbolic(A, port_common())
        num = port_qr.qr_factorize(A, Ssym, device=CPU)
        ss = Ssym.ss
        h = num.Rbuf.numpy()
        n = 45
        R = np.zeros((n, n))
        for s in range(ss.nsuper):
            ms, ns_ = ss.panel_shape(s)
            Np, Mp = int(ss.panel_Np[s]), int(ss.panel_Mp[s])
            o = int(ss.panel_off[s])
            pn = h[o:o + Mp * Np].reshape(Mp, Np)
            j1 = int(ss.super[s])
            rows_s = ss.rows_of(s)
            vals = np.concatenate([pn[:ns_, :], pn[Np:Np + (ms - ns_), :]],
                                  axis=0)
            for t in range(ns_):
                R[j1 + t, rows_s] = vals[:, t]
        AtA = (S.T @ S).toarray()
        p = Ssym.sym.perm
        assert np.abs(R.T @ R - AtA[np.ix_(p, p)]).max() < 1e-8

    def test_rank_detection(self):
        rng = np.random.default_rng(4)
        S = sp.random(50, 30, density=0.3, random_state=rng).tolil()
        S[:, 7] = S[:, 3]       # duplicate column -> rank 29
        Ar, Ap = _pair(S.tocsc())
        b = rng.standard_normal(50)
        cm = port_common()
        x = port_qr.qr_solve(Ap, b, cm, device=CPU)
        assert cm.info["qr_rank"] == 29
        assert cm.status == Status.SINGULAR
        assert np.isfinite(x).all()
        # the same dead column is zeroed in both packages; the live
        # entries are the least-squares solution over the live columns
        # (repaired: the reference drops the dead row's equation, whose
        # entries come from the reflector LAPACK draws for the dead
        # pivot's rounding noise)
        cr = ref_common()
        xr = ref_qr.qr_solve(Ar, b, cr)
        assert cr.info["qr_rank"] == 29
        assert np.array_equal(x == 0, xr == 0) and np.sum(x == 0) == 1
        live = x != 0
        want = np.linalg.lstsq(S.tocsc()[:, live].toarray(), b,
                               rcond=None)[0]
        assert np.abs(x[live] - want).max() < 1e-10

    def test_multi_rhs(self):
        S = _rand_tall(60, 35, 0.2, 5)
        Ar, Ap = _pair(S)
        B = np.random.default_rng(5).standard_normal((60, 3))
        X = port_qr.qr_solve(Ap, B, device=CPU)
        X_ref, *_ = np.linalg.lstsq(S.toarray(), B, rcond=None)
        assert X.shape == (35, 3)
        assert np.abs(X - X_ref).max() < 1e-9
        assert np.abs(X - ref_qr.qr_solve(Ar, B)).max() < SOL_TOL

    def test_min2norm_underdetermined(self):
        """m < n: qr_solve gives the minimum 2-norm solution (QR of A')."""
        rng = np.random.default_rng(6)
        S = sp.csc_matrix(_rand_tall(40, 20, 0.3, 6).T)   # 20 x 40
        Ar, Ap = _pair(S)
        b = rng.standard_normal(20)
        x = port_qr.qr_solve(Ap, b, device=CPU)
        assert np.linalg.norm(S @ x - b, np.inf) < 1e-8
        x_ref = np.linalg.pinv(S.toarray()) @ b
        assert np.linalg.norm(x) == pytest.approx(np.linalg.norm(x_ref),
                                                  rel=1e-8)
        assert np.abs(x - x_ref).max() < 1e-8
        assert np.abs(x - ref_qr.qr_solve(Ar, b)).max() < SOL_TOL

    def test_tol_override(self):
        S = _rand_tall(40, 25, 0.3, 7)
        A = PortCSC.from_scipy(S)
        cm = port_common()
        port_qr.qr_solve(A, np.ones(40), cm, tol=1e30, device=CPU)
        assert cm.info["qr_rank"] == 0
        cm.qr.tol = 1e30           # the Common's own tol
        A2 = PortCSC.from_scipy(S)
        num = port_qr.qr_factorize(A2, port_qr.qr_symbolic(A2), common=cm,
                                   device=CPU)
        assert num.rank == 0 and num.tol == 1e30


class TestQmult:
    """SuiteSparseQR_qmult equivalents (keep_q=True retains front Qs)."""

    def _factor(self, m=50, n=30, d=0.2, seed=8):
        S = _rand_tall(m, n, d, seed)
        Ar, Ap = _pair(S)
        Ssym = port_qr.qr_symbolic(Ap)
        num = port_qr.qr_factorize(Ap, Ssym, keep_q=True, device=CPU)
        nr = ref_qr.qr_factorize(Ar, ref_qr.qr_symbolic(Ar), keep_q=True)
        return S, Ap, Ssym, num, nr

    def test_qtx_isometry_and_inverse(self):
        S, A, Ssym, num, nr = self._factor()
        X = np.random.default_rng(8).standard_normal((50, 2))
        Y = port_qr.qr_qmult(num, X, "QTX")
        assert np.linalg.norm(Y, axis=0) == pytest.approx(
            np.linalg.norm(X, axis=0), rel=1e-10)
        Xr = port_qr.qr_qmult(num, Y, "QX")
        assert np.abs(Xr - X).max() < 1e-10
        # the reference's Q'X up to the same row signs as R
        sp_ = _signs(Ssym, num.Rbuf.numpy())
        sr = _signs(nr.symbolic, np.asarray(nr.Rbuf))
        Yr = ref_qr.qr_qmult(nr, X, "QTX")
        assert _rel(Y[:30] * sp_[:, None], Yr[:30] * sr[:, None]) <= 1e-10

    def test_qtx_reproduces_r(self):
        """Q'A (cols permuted) has R in its pivotal rows."""
        S, A, Ssym, num, nr = self._factor(40, 25, 0.25, 9)
        p = Ssym.sym.perm
        QtA = port_qr.qr_qmult(num, S[:, p].toarray(), "QTX")
        n = 25
        assert np.abs(QtA[n:]).max() < 1e-9
        assert np.abs(np.tril(QtA[:n], -1)).max() < 1e-9
        Q = port_qr.qr_q(num, econ=True)
        assert np.abs(Q @ QtA[:n] - S[:, p].toarray()).max() < 1e-9
        assert np.abs(Q.T @ Q - np.eye(Q.shape[1])).max() < 1e-10

    def test_xqt_xq_transposed_methods(self):
        S, A, Ssym, num, nr = self._factor(35, 20, 0.3, 10)
        X = np.random.default_rng(10).standard_normal((4, 35))
        XQ = port_qr.qr_qmult(num, X, "XQ")
        back = port_qr.qr_qmult(num, XQ, "XQT")
        assert np.abs(back - X).max() < 1e-10

    def test_qtb_matches_carried(self):
        """qmult(QTX, b) pivotal rows == the carried Q'b from factorize."""
        S = _rand_tall(45, 30, 0.2, 11)
        A = PortCSC.from_scipy(S)
        b = np.random.default_rng(11).standard_normal(45)
        Ssym = port_qr.qr_symbolic(A)
        num = port_qr.qr_factorize(A, Ssym, b=b, keep_q=True, device=CPU)
        y = port_qr.qr_qmult(num, b, "QTX")
        assert np.abs(y[:30] - num.qtb[:, 0]).max() < 1e-8

    def test_complex_qr_solve_and_qmult(self):
        """Complex least squares + unitary qmult (SPQR <Complex> variant)."""
        rng = np.random.default_rng(13)
        S = _complex_tall(50, 30, 0.2, 13)
        Ar, Ap = _pair(S)
        b = rng.standard_normal(50) + 1j * rng.standard_normal(50)
        x = port_qr.qr_solve(Ap, b, device=CPU)
        x_ref, *_ = np.linalg.lstsq(S.toarray(), b, rcond=None)
        assert np.abs(x - x_ref).max() < 1e-8
        assert np.abs(x - ref_qr.qr_solve(Ar, b)).max() < SOL_TOL
        num = port_qr.qr_factorize(Ap, port_qr.qr_symbolic(Ap), keep_q=True,
                                   device=CPU)
        assert num.Rbuf.dtype == torch.complex128
        X = rng.standard_normal((50, 2)) + 1j * rng.standard_normal((50, 2))
        Y = port_qr.qr_qmult(num, X, "QTX")
        assert np.linalg.norm(Y, axis=0) == pytest.approx(
            np.linalg.norm(X, axis=0), rel=1e-10)
        assert np.abs(port_qr.qr_qmult(num, Y, "QX") - X).max() < 1e-10

    def test_complex_min2norm(self):
        rng = np.random.default_rng(14)
        S = _rand_tall(45, 25, 0.25, 14).T.astype(complex)   # 25 x 45
        S = (S + 1j * sp.random(25, 45, density=0.1,
                                random_state=rng)).tocsc()
        Ar, Ap = _pair(S)
        b = rng.standard_normal(25) + 1j * rng.standard_normal(25)
        x = port_qr.qr_min2norm(Ap, b, device=CPU)
        assert np.linalg.norm(S @ x - b, np.inf) < 1e-8
        x_ref = np.linalg.pinv(S.toarray()) @ b
        assert np.abs(x - x_ref).max() < 1e-8
        assert np.abs(x - ref_qr.qr_min2norm(Ar, b)).max() < SOL_TOL

    def test_qmult_requires_keep_q(self):
        A = PortCSC.from_scipy(_rand_tall(30, 20, 0.3, 12))
        num = port_qr.qr_factorize(A, port_qr.qr_symbolic(A), device=CPU)
        with pytest.raises(SparseError) as e:
            port_qr.qr_qmult(num, np.ones(30), "QTX")
        assert e.value.status == Status.INVALID


# ---------------------------------------------------------------------------
# spqr_rank (models/spqr_rank.py)
# ---------------------------------------------------------------------------

def _projector(N):
    return N @ np.conj(N).T


class TestSpqrRank:
    def test_null_basis_wide(self):
        S = sp.csc_matrix(_rand_tall(40, 22, 0.3, 80).T)    # 22 x 40
        Ar, Ap = _pair(S)
        N = port_models.spqr_null(Ap, device=CPU)
        assert N.shape == (40, 18)
        assert np.abs(S @ N).max() < 1e-8
        assert np.abs(N.T @ N - np.eye(18)).max() < 1e-10
        Nr = ref_models.spqr_null(Ar)
        assert np.abs(_projector(N) - _projector(Nr)).max() < 1e-10

    @pytest.mark.parametrize("k", [3, 4, 6])
    def test_null_of_gradient_is_the_constants(self, k):
        """A tall rank-deficient A: the port's repaired spqr_null returns
        the one null vector, ones / sqrt(n).  The reference's (QR of the
        wide A^H, one Q column per dead pivot) returns more columns, not
        all of them null vectors: the deliberate difference."""
        S = _grad(k)
        Ar, Ap = _pair(S)
        n = S.shape[1]
        N = port_models.spqr_null(Ap, device=CPU)
        assert N.shape == (n, 1)
        assert np.abs(np.abs(N[:, 0]) - 1 / np.sqrt(n)).max() < 1e-12
        assert np.abs(S @ N).max() < 1e-12
        Nr = ref_models.spqr_null(Ar)
        assert Nr.shape[1] > 1 and np.abs(S @ Nr).max() > 0.1

    def test_null_of_wide_rank_deficient(self):
        """A wide A whose A^H has dead pivots: the residual slots plus R's
        left null vectors span null(A) (n - rank columns)."""
        S = sp.csc_matrix(_grad(3).T)                  # 27 x 54, rank 26
        Ar, Ap = _pair(S)
        N = port_models.spqr_null(Ap, device=CPU)
        assert N.shape == (54, 28)
        assert np.abs(S @ N).max() < 1e-12
        assert np.abs(N.T @ N - np.eye(28)).max() < 1e-12
        x = np.linalg.lstsq(S.toarray(), np.ones(27), rcond=None)[0]
        dense = np.linalg.svd(S.toarray())[2][26:].T     # oracle basis
        assert np.abs(_projector(N) - _projector(dense)).max() < 1e-10
        assert x.shape == (54,)

    def test_null_empty_for_full_rank_tall(self):
        S = _rand_tall(50, 30, 0.2, 81)
        Ar, Ap = _pair(S)
        assert port_models.spqr_null(Ap, device=CPU).shape == (30, 0)
        assert port_models.spqr_rank(Ap, device=CPU) == 30
        assert ref_models.spqr_rank(Ar) == 30

    def test_pinv_matches_numpy_and_reference(self):
        rng = np.random.default_rng(82)
        S = sp.csc_matrix(_rand_tall(45, 25, 0.25, 82).T)
        Ar, Ap = _pair(S)
        b = rng.standard_normal(25)
        x = port_models.spqr_pinv(Ap, b, device=CPU)
        assert np.abs(x - np.linalg.pinv(S.toarray()) @ b).max() < 1e-8
        assert np.abs(x - ref_models.spqr_pinv(Ar, b)).max() < SOL_TOL
        T = _rand_tall(50, 30, 0.3, 83).tolil()
        T[:, 7] = T[:, 3]
        T = T.tocsc()
        Ar2, Ap2 = _pair(T)
        b2 = rng.standard_normal(50)
        x2 = port_models.spqr_pinv(Ap2, b2, device=CPU)
        assert np.abs(x2 - np.linalg.pinv(T.toarray()) @ b2).max() < 1e-6
        assert np.abs(x2 - ref_models.spqr_pinv(Ar2, b2)).max() < SOL_TOL

    @pytest.mark.parametrize("wide", [False, True])
    def test_numerically_rank_deficient_pinv_and_least_squares(self, wide):
        """Two columns that depend on earlier ones: the basic solution is
        the least-squares one over the live columns (tall), the wide
        solve a least-squares solution, and spqr_pinv numpy's pinv."""
        rng = np.random.default_rng(4)
        T = sp.random(50, 30, density=0.3, random_state=rng).tolil()
        T[:, 7] = T[:, 3]
        T[:, 11] = T[:, 2] + T[:, 20]
        T = T.tocsc()
        if wide:
            T = sp.csc_matrix(T.T)
        Ap = PortCSC.from_scipy(T)
        b = rng.standard_normal(T.shape[0])
        P = np.linalg.pinv(T.toarray())
        x = port_qr.qr_solve(Ap, b, device=CPU)
        # least-squares optimality: the residual is that of pinv's x
        assert np.linalg.norm(T @ x - b) == pytest.approx(
            np.linalg.norm(T @ (P @ b) - b), rel=1e-10)
        if not wide:
            live = x != 0
            assert np.sum(~live) == 2
            want = np.linalg.lstsq(T[:, live].toarray(), b, rcond=None)[0]
            assert np.abs(x[live] - want).max() < 1e-10
        xp = port_models.spqr_pinv(Ap, b, device=CPU)
        assert np.abs(xp - P @ b).max() < 1e-10
        N = port_models.spqr_null(Ap, device=CPU)
        assert N.shape[1] == T.shape[1] - 28
        assert np.abs(T @ N).max() < 1e-12

    def test_basic_matches_reference(self):
        """The basic solution of the gradient (rank n - 1, its dead pivot
        the last column): the least-squares solution with that column
        removed, in both packages."""
        S = _grad(5)
        Ar, Ap = _pair(S)
        b = np.random.default_rng(84).standard_normal(S.shape[0])
        x = port_models.spqr_basic(Ap, b, device=CPU)
        xr = ref_models.spqr_basic(Ar, b)
        assert np.abs(x - xr).max() < SOL_TOL
        dead = np.nonzero(x == 0)[0]
        assert len(dead) == 1
        keep = np.arange(S.shape[1]) != dead[0]
        want = np.linalg.lstsq(S[:, keep].toarray(), b, rcond=None)[0]
        assert np.abs(x[keep] - want).max() < 1e-10

    def test_pinv_of_gradient(self):
        S = _grad(4)
        Ar, Ap = _pair(S)
        b = np.random.default_rng(85).standard_normal(S.shape[0])
        x = port_models.spqr_pinv(Ap, b, device=CPU)
        assert np.abs(x - np.linalg.pinv(S.toarray()) @ b).max() < 1e-10

    @pytest.mark.parametrize("wide", [False, True])
    def test_rank_deficient_rank(self, wide):
        T = _rand_tall(40, 25, 0.3, 84).tolil()
        T[:, 5] = 2.0 * T[:, 1]
        T = T.tocsc()
        if wide:
            T = sp.csc_matrix(T.T)
        Ar, Ap = _pair(T)
        assert port_models.spqr_rank(Ap, device=CPU) == 24
        assert ref_models.spqr_rank(Ar) == 24
