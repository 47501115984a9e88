"""The port's front ends against the JAX reference on the CPU in float64:
Factorize / backslash (models/factorize.py) and every cs_* function of the
CSparse layer (models/csparse.py), on the same seeded inputs.  Factorize
picks the same kind and backslash agrees within 1e-10; cs_* results are
identical for integer and permutation outputs and within 1e-12 relative
for values.  One deliberate difference is pinned: an exception other
than not-positive-definite inside Factorize's Cholesky branch
propagates in the port, where the reference falls through to LU."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.models as ref_models
from suitesparse_tpu.core import sparse as ref_sparse
from suitesparse_tpu.io import generators as ref_gen
from suitesparse_tpu.models import csparse as ref_cs

import suitesparse_tpu_torch.models as port_models
import suitesparse_tpu_torch.models.factorize as port_factorize
from suitesparse_tpu_torch.cholesky import kernels
from suitesparse_tpu_torch.core import sparse as port_sparse
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.status import Status
from suitesparse_tpu_torch.io import generators as port_gen
from suitesparse_tpu_torch.models import csparse as port_cs

CPU = "cpu"
TOL = 1e-12
SOL_TOL = 1e-10


def _rand(m, n, d, seed):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=d, random_state=rng, format="csc")


def _pair(S, stype=0):
    S = sp.csc_matrix(S)
    return (ref_sparse.SparseCSC(S.indptr, S.indices, S.data, S.shape,
                                 stype=stype),
            port_sparse.SparseCSC(S.indptr, S.indices, S.data, S.shape,
                                  stype=stype))


def _spd(n=40, seed=1):
    A = ref_gen.random_spd(n, 0.1, seed=seed)
    return A.to_scipy().tocsc()


def _unsym(n=40, seed=2):
    return ref_gen.random_unsym(n, 0.1, seed=seed).to_scipy().tocsc()


def _rect(seed=3):
    S = _rand(30, 20, 0.3, seed)
    return (S + sp.csc_matrix((np.ones(20), (range(20), range(20))),
                              shape=(30, 20))).tocsc()


def _indefinite(n=30):
    """Symmetric, positive diagonal, indefinite: Factorize guesses
    Cholesky, which fails NOT_POSDEF, and falls through to LU."""
    L = port_gen.laplacian_2d(6).to_scipy().tocsc()[:n, :n]
    return (L - 3.0 * sp.identity(n)).tocsc()


MATRICES = {"spd": (_spd, "cholesky"), "unsym": (_unsym, "lu"),
            "rect": (_rect, "qr"), "indefinite": (_indefinite, "lu")}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_factorize_picks_the_reference_kind_and_agrees(name):
    make, kind = MATRICES[name]
    S = make()
    Ar, Ap = _pair(S)
    Fr = ref_models.Factorize(Ar)
    Fp = port_models.Factorize(Ap, device=CPU)
    assert Fp.kind == Fr.kind == kind
    b = np.random.default_rng(7).standard_normal(S.shape[0])
    xp, xr = Fp.solve(b), Fr.solve(b)
    assert np.abs(xp - xr).max() <= SOL_TOL * max(1.0, np.abs(xr).max())
    xb = port_models.backslash(Ap, b, device=CPU)
    assert np.abs(xb - ref_models.backslash(Ar, b)).max() <= \
        SOL_TOL * max(1.0, np.abs(xr).max())
    if kind != "qr":
        assert np.abs(S @ xp - b).max() < 1e-8
    assert np.abs(Fp(b) - xp).max() == 0


def test_pattern_symmetric_unsymmetric_values_take_lu():
    """A convection-diffusion operator (symmetric pattern, unsymmetric
    values, positive diagonal): the port guesses Cholesky only for a
    Hermitian matrix and solves it by LU; the reference guesses Cholesky
    from the pattern and solves the wrong matrix (its upper triangle's)."""
    from chip_smoke import cd3d
    A = cd3d(5)
    S = A.to_scipy().tocsc()
    Ar, Ap = _pair(S)
    b = np.random.default_rng(8).standard_normal(A.ncol)
    Fp = port_models.Factorize(Ap, device=CPU)
    assert Fp.kind == "lu"
    assert np.abs(S @ Fp.solve(b) - b).max() < 1e-10
    assert np.abs(S @ port_models.backslash(Ap, b, device=CPU) - b).max() \
        < 1e-10
    Fr = ref_models.Factorize(Ar)
    assert Fr.kind == "cholesky" and np.abs(S @ Fr.solve(b) - b).max() > 0.1
    # a Hermitian matrix still takes Cholesky, in full or symmetric storage
    H = _spd(30, 9)
    assert port_models.Factorize(_pair(H)[1], device=CPU).kind == "cholesky"
    U = sp.triu(H).tocsc()
    assert port_models.Factorize(_pair(U, stype=1)[1],
                                 device=CPU).kind == "cholesky"


def test_indefinite_symmetric_falls_through_to_lu_on_not_posdef():
    """The narrowed branch still takes the reference's route for the
    not-positive-definite outcome: status NOT_POSDEF, then LU."""
    Ap = _pair(_indefinite())[1]
    cm = port_common()
    seen = []
    real = port_factorize.cholesky

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(cm.status)
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(port_factorize, "cholesky", spy)
        F = port_models.Factorize(Ap, cm, device=CPU)
    finally:
        mp.undo()
    assert seen == [Status.NOT_POSDEF] and F.kind == "lu"


@pytest.mark.parametrize("where", ["cholesky", "block_chol"])
def test_other_cholesky_errors_propagate(monkeypatch, where):
    """A RuntimeError inside the Cholesky branch (the whole call, or the
    diagonal-block kernel's wrapper) reaches the caller: no silent LU.
    The reference turns the same failure into an LU solve."""
    A = port_gen.laplacian_3d(8)
    S = A.to_scipy().tocsc()
    Ar, Ap = _pair(S)
    cm = port_common()
    cm.cholesky.program = "pf"            # block_chol on its path

    def boom(*args, **kw):
        raise RuntimeError("kernel launch failed")

    if where == "cholesky":
        monkeypatch.setattr(port_factorize, "cholesky", boom)
    else:
        monkeypatch.setattr(kernels, "block_chol_plain", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_models.backslash(Ap, np.ones(A.ncol), cm, device=CPU)
    import suitesparse_tpu.cholesky as ref_chol
    monkeypatch.setattr(ref_chol, "cholesky", boom)
    F = ref_models.Factorize(Ar)
    assert F.kind == "lu"


def test_factorize_spd_runs_the_diagonal_block_kernel_wrapper():
    """The SPD branch reaches block_chol (its plain version on the CPU);
    the unsymmetric and rectangular branches do not."""
    A = port_gen.laplacian_3d(8)
    cm = port_common()
    cm.cholesky.program = "pf"            # the program that runs block_chol
    before = kernels.block_chol.launches
    calls = []
    real = kernels.block_chol_plain

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(kernels, "block_chol_plain", counting)
        F = port_models.Factorize(A, cm, device=CPU)
        n_spd = len(calls)
        port_models.Factorize(_pair(_unsym())[1], device=CPU)
        port_models.backslash(_pair(_rect())[1], np.ones(30), device=CPU)
    finally:
        mp.undo()
    assert F.kind == "cholesky" and n_spd > 0 and len(calls) == n_spd
    assert kernels.block_chol.launches == before    # no card launch here


# ---------------------------------------------------------------------------
# cs_*: every function against the reference
# ---------------------------------------------------------------------------

def _same(a, b, path="result"):
    """Recursive comparison: integers, bools and patterns exact, values
    within TOL relative."""
    if a is None or b is None:
        assert a is None and b is None, path
        return
    if isinstance(b, torch.Tensor):
        b = b.numpy()
    if hasattr(a, "devices") and hasattr(a, "block_until_ready"):
        a = np.asarray(a)
    if hasattr(a, "indptr") and hasattr(a, "indices") and hasattr(a, "shape") \
            and not isinstance(a, np.ndarray):
        assert tuple(a.shape) == tuple(b.shape), path
        assert getattr(a, "stype", 0) == getattr(b, "stype", 0), path
        _same(np.asarray(a.indptr), np.asarray(b.indptr), path + ".indptr")
        _same(np.asarray(a.indices), np.asarray(b.indices),
              path + ".indices")
        _same(None if a.data is None else np.asarray(a.data),
              None if b.data is None else np.asarray(b.data), path + ".data")
        return
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                _same(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{k}]")
        return
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
        return
    if isinstance(a, (str, bool)):
        assert a == b, path
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, path
    if a.dtype.kind in "biu" and b.dtype.kind in "biu":
        assert np.array_equal(a, b), path
    elif a.dtype.kind == "O":
        for k, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
            _same(x, y, f"{path}[{k}]")
    else:
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
        assert float(np.abs(a - b).max(initial=0.0)) <= TOL * scale, path


def _tri(lower, seed=6):
    M = _rand(12, 12, 0.4, seed) + 2 * sp.identity(12)
    T = sp.tril(M) if lower else sp.triu(M)
    T = sp.csc_matrix(T)
    T.sort_indices()
    return T


SYM = lambda: sp.triu(_spd(30, 5)).tocsc()          # noqa: E731


def _case(name, tmp_path):
    """(ref_result, port_result) of one cs_* function on the same inputs."""
    rng = np.random.default_rng(11)
    U = _unsym(30, 4)
    Ar, Ap = _pair(U)
    Br, Bp = _pair(_rand(30, 30, 0.1, 12))
    b = np.ones(30)
    run = {}
    if name == "cs_add":
        run = dict(args=lambda cs, A, B: cs.cs_add(A, B, 2.0, -0.5))
    elif name == "cs_multiply":
        run = dict(args=lambda cs, A, B: cs.cs_multiply(A, B))
    elif name == "cs_gaxpy":
        y = rng.standard_normal(30)
        run = dict(args=lambda cs, A, B: cs.cs_gaxpy(A, np.arange(30.0), y))
    elif name == "cs_transpose":
        run = dict(args=lambda cs, A, B: cs.cs_transpose(A))
    elif name in ("cs_compress", "cs_entry"):
        t = sp.coo_matrix(U)

        def go(cs, A, B):
            mod = ref_sparse if cs is ref_cs else port_sparse
            T = mod.Triplet(t.row.astype(np.int64), t.col.astype(np.int64),
                            t.data.copy(), t.shape)
            if name == "cs_entry":
                T = cs.cs_entry(T, 3, 4, 2.5)
                return T.row, T.col, T.data
            return cs.cs_compress(T)
        run = dict(args=go)
    elif name == "cs_norm":
        run = dict(args=lambda cs, A, B: cs.cs_norm(A))
    elif name == "cs_print":
        import contextlib
        import io as _io

        def go(cs, A, B):
            buf = _io.StringIO()
            with contextlib.redirect_stdout(buf):
                cs.cs_print(A, brief=False)
            return buf.getvalue()
        run = dict(args=go)
    elif name == "cs_load":
        p = tmp_path / "t.txt"
        t = sp.coo_matrix(U)
        np.savetxt(p, np.column_stack([t.row, t.col, t.data]))
        run = dict(args=lambda cs, A, B: cs.cs_load(str(p)))
    elif name == "cs_lusol":
        run = dict(args=lambda cs, A, B: cs.cs_lusol(A, b))
    elif name == "cs_cholsol":
        Sr, Sp = _pair(_spd(30, 5))
        return ref_cs.cs_cholsol(Sr, b), port_cs.cs_cholsol(Sp, b, device=CPU)
    elif name == "cs_qrsol":
        Rr, Rp = _pair(_rect())
        return (ref_cs.cs_qrsol(Rr, np.ones(30)),
                port_cs.cs_qrsol(Rp, np.ones(30), device=CPU))
    elif name == "cs_qr":
        Rr, Rp = _pair(_rect())
        Sr, nr = ref_cs.cs_qr(Rr)
        Sp, np_ = port_cs.cs_qr(Rp, device=CPU)
        return ((Sr, np.asarray(nr.Rbuf), nr.qtb, nr.rank, nr.tol),
                (Sp, np_.Rbuf, np_.qtb, np_.rank, np_.tol))
    elif name == "cs_dmperm":
        run = dict(args=lambda cs, A, B: cs.cs_dmperm(B))
    elif name == "cs_scc":
        run = dict(args=lambda cs, A, B: cs.cs_scc(B))
    elif name in ("cs_amd", "cs_amd_natural", "cs_amd_sym"):
        order = 0 if name == "cs_amd_natural" else 1
        if name == "cs_amd_sym":
            Sr, Sp = _pair(SYM(), stype=1)
            return ref_cs.cs_amd(Sr, order), port_cs.cs_amd(Sp, order)
        run = dict(args=lambda cs, A, B: cs.cs_amd(A, order))
    elif name in ("cs_etree", "cs_etree_ata"):
        ata = name.endswith("ata")
        if ata:
            run = dict(args=lambda cs, A, B: cs.cs_etree(A, ata=True))
        else:
            Sr, Sp = _pair(SYM(), stype=1)
            return ref_cs.cs_etree(Sr), port_cs.cs_etree(Sp)
    elif name in ("cs_post", "cs_counts"):
        Sr, Sp = _pair(SYM(), stype=1)

        def go(cs, S):
            par = cs.cs_etree(S)
            post = cs.cs_post(par)
            return post if name == "cs_post" else cs.cs_counts(S, par, post)
        return go(ref_cs, Sr), go(port_cs, Sp)
    elif name == "cs_chol":
        Sr, Sp = _pair(_spd(30, 5))
        return ref_cs.cs_chol(Sr), port_cs.cs_chol(Sp)
    elif name == "cs_lu":
        run = dict(args=lambda cs, A, B: cs.cs_lu(A))
    elif name in ("cs_lsolve", "cs_ltsolve", "cs_usolve", "cs_utsolve"):
        Tr, Tp = _pair(_tri(lower=name in ("cs_lsolve", "cs_ltsolve")))
        fn = name
        return (getattr(ref_cs, fn)(Tr, b[:12]),
                getattr(port_cs, fn)(Tp, b[:12]))
    elif name in ("cs_spsolve", "cs_spsolve_upper", "cs_reach"):
        lower = name != "cs_spsolve_upper"
        Tr, Tp = _pair(_tri(lower=lower))
        Rhs = _rand(12, 3, 0.3, 13)
        Rhs = sp.csc_matrix(Rhs)
        Rhs.sort_indices()
        Xr, Xp = _pair(Rhs)
        if name == "cs_reach":
            return ([ref_cs.cs_reach(Tr, Xr, k) for k in range(3)],
                    [port_cs.cs_reach(Tp, Xp, k) for k in range(3)])
        return ([ref_cs.cs_spsolve(Tr, Xr, k, lower) for k in range(3)],
                [port_cs.cs_spsolve(Tp, Xp, k, lower) for k in range(3)])
    elif name == "cs_maxtrans":
        run = dict(args=lambda cs, A, B: cs.cs_maxtrans(B))
    elif name == "cs_permute":
        p, q = rng.permutation(30), rng.permutation(30)
        run = dict(args=lambda cs, A, B: cs.cs_permute(A, p, q))
    elif name == "cs_symperm":
        p = rng.permutation(30)
        Sr, Sp = _pair(SYM(), stype=1)
        return ref_cs.cs_symperm(Sr, p), port_cs.cs_symperm(Sp, p)
    elif name in ("cs_pinv", "cs_pvec", "cs_ipvec"):
        p = rng.permutation(30)
        x = rng.standard_normal(30)
        if name == "cs_pinv":
            run = dict(args=lambda cs, A, B: cs.cs_pinv(p))
        else:
            run = dict(args=lambda cs, A, B: getattr(cs, name)(p, x))
    elif name in ("cs_droptol", "cs_dropzeros"):
        D = U.copy()
        D.data[::3] = 0.0
        D.data[1::3] *= 1e-3
        Dr, Dp = _pair(D)
        if name == "cs_droptol":
            return ref_cs.cs_droptol(Dr, 0.01), port_cs.cs_droptol(Dp, 0.01)
        return ref_cs.cs_dropzeros(Dr), port_cs.cs_dropzeros(Dp)
    elif name == "cs_fkeep":
        run = dict(args=lambda cs, A, B: cs.cs_fkeep(
            A, lambda i, j, x: i >= j and x > 0.5))
    elif name == "cs_updown":
        Sr, Sp = _pair(_spd(30, 5))
        Cs = sp.csc_matrix(_rand(30, 1, 0.2, 14) * 0.1)
        Cr, Cp = _pair(Cs)
        import suitesparse_tpu.cholesky as ref_chol
        import suitesparse_tpu_torch.cholesky as port_chol
        fr = ref_chol.factorize_simplicial(Sr)
        fp = port_chol.factorize_simplicial(Sp)
        return (ref_cs.cs_updown(fr, 1, Cr), port_cs.cs_updown(fp, 1, Cp))
    elif name == "cs_house":
        x = rng.standard_normal(7)
        return (ref_cs.cs_house(x), port_cs.cs_house(x),)
    elif name == "cs_house_edge":
        return ([ref_cs.cs_house(np.array([v, 0.0, 0.0])) for v in
                 (2.0, -2.0, 0.0)],
                [port_cs.cs_house(np.array([v, 0.0, 0.0])) for v in
                 (2.0, -2.0, 0.0)])
    elif name == "cs_happly":
        V = sp.csc_matrix(_rand(30, 3, 0.4, 15))
        Vr, Vp = _pair(V)
        x = rng.standard_normal(30)
        return (ref_cs.cs_happly(Vr, 1, 0.7, x),
                port_cs.cs_happly(Vp, 1, 0.7, x))
    elif name == "cs_randperm":
        run = dict(args=lambda cs, A, B: cs.cs_randperm(25, seed=3))
    elif name == "cs_cumsum":
        run = dict(args=lambda cs, A, B: cs.cs_cumsum(np.arange(9) % 4))
    elif name == "cs_scatter":
        def go(cs, A, B):
            w = np.zeros(30, dtype=np.int64)
            x = np.zeros(30)
            fresh1 = cs.cs_scatter(A, 2, 1.5, w, x, 1)
            fresh2 = cs.cs_scatter(A, 5, -2.0, w, x, 1)
            return fresh1, fresh2, w, x
        run = dict(args=go)
    else:
        raise KeyError(name)
    return run["args"](ref_cs, Ar, Br), run["args"](port_cs, Ap, Bp)


CS_CASES = (
    "cs_add", "cs_multiply", "cs_gaxpy", "cs_transpose", "cs_compress",
    "cs_entry", "cs_norm", "cs_print", "cs_load", "cs_lusol", "cs_cholsol",
    "cs_qrsol", "cs_qr", "cs_dmperm", "cs_scc", "cs_amd", "cs_amd_natural",
    "cs_amd_sym", "cs_etree", "cs_etree_ata", "cs_post", "cs_counts",
    "cs_chol", "cs_lu", "cs_lsolve", "cs_ltsolve", "cs_usolve",
    "cs_utsolve", "cs_spsolve", "cs_spsolve_upper", "cs_reach",
    "cs_maxtrans", "cs_permute", "cs_symperm", "cs_pinv", "cs_pvec",
    "cs_ipvec", "cs_droptol", "cs_dropzeros", "cs_fkeep", "cs_updown",
    "cs_house", "cs_house_edge", "cs_happly", "cs_randperm", "cs_cumsum",
    "cs_scatter")


def test_every_cs_function_has_a_case():
    names = {n for n in dir(port_cs) if n.startswith("cs_")}
    assert names == {n for n in dir(ref_cs) if n.startswith("cs_")}
    variants = {"cs_house_edge": "cs_house", "cs_amd_natural": "cs_amd",
                "cs_amd_sym": "cs_amd", "cs_etree_ata": "cs_etree",
                "cs_spsolve_upper": "cs_spsolve"}
    covered = {variants.get(c, c) for c in CS_CASES}
    assert names <= covered, names - covered


@pytest.mark.parametrize("name", CS_CASES)
def test_cs_function_matches_reference(name, tmp_path):
    ref, port = _case(name, tmp_path)
    _same(ref, port)


def test_cs_counts_ata_not_available():
    from suitesparse_tpu_torch.core.status import SparseError
    Sp = _pair(SYM(), stype=1)[1]
    with pytest.raises(SparseError) as e:
        port_cs.cs_counts(Sp, None, None, ata=True)
    assert e.value.status == Status.NOT_AVAILABLE
