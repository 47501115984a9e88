"""The port's LU extras against the JAX reference: SLIP exact solves
(Fractions, identical), sparseinv (within 1e-12), the umfpack report
functions (the same text) and core.check (the same verdicts and text)."""
from fractions import Fraction

import numpy as np
import pytest
import scipy.sparse as sp

import suitesparse_tpu.core as ref_core
import suitesparse_tpu.lu as ref_lu
from suitesparse_tpu.cholesky import factorize_simplicial as ref_simplicial
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.core.status import SparseError as RefError
from suitesparse_tpu.models import sparseinv as ref_sparseinv

import suitesparse_tpu_torch.core as port_core
import suitesparse_tpu_torch.lu as port_lu
from suitesparse_tpu_torch.cholesky import \
    factorize_simplicial as port_simplicial
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import SparseError as PortError
from suitesparse_tpu_torch.io import generators
from suitesparse_tpu_torch.models import sparseinv as port_sparseinv


def _pair(A):
    return RefCSC(A.indptr, A.indices, A.data, A.shape, stype=A.stype), A


def _integer_matrix(n=25, seed=5):
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=0.2, random_state=rng, format="csc")
    M.data = np.round(M.data * 9)
    M = sp.csc_matrix(M + 7 * sp.identity(n))
    return PortCSC.from_scipy(M), rng.integers(-9, 9, n).astype(float)


@pytest.mark.parametrize("ordering", ["colamd", "amd", "none"])
@pytest.mark.parametrize("pivot", ["smallest", "largest", "first",
                                   "diagonal"])
def test_slip_exact_solves_are_the_reference(ordering, pivot):
    A, b = _integer_matrix()
    Ar, Ap = _pair(A)
    xr = ref_lu.slip_backslash(Ar, b, ordering=ordering, pivot=pivot)
    xp = port_lu.slip_backslash(Ap, b, ordering=ordering, pivot=pivot)
    assert all(isinstance(v, Fraction) for v in xp)
    assert xp == xr
    D = A.to_scipy().toarray()
    assert all(sum(Fraction(D[i, j].item()) * xp[j] for j in range(25))
               == Fraction(b[i].item()) for i in range(25))
    # the pieces: the same column order and the same exact factors
    qr = ref_lu.slip_lu_analyze(Ar, ordering=ordering)
    qp = port_lu.slip_lu_analyze(Ap, ordering=ordering)
    assert np.array_equal(qr, qp)
    fr = ref_lu.slip_lu_factorize(Ar, qr, pivot=pivot)
    fp = port_lu.slip_lu_factorize(Ap, qp, pivot=pivot)
    assert fr[:3] == fp[:3] and np.array_equal(fr[3], fp[3])
    B = np.stack([b, -2 * b], axis=1)
    assert port_lu.slip_lu_solve(fp, qp, B) == ref_lu.slip_lu_solve(fr, qr, B)


def test_slip_singular_raises_in_both():
    S = PortCSC.from_scipy(sp.csc_matrix(np.array([[1.0, 2.0],
                                                   [2.0, 4.0]])))
    Ar, Ap = _pair(S)
    with pytest.raises(RefError):
        ref_lu.slip_backslash(Ar, np.ones(2))
    with pytest.raises(PortError):
        port_lu.slip_backslash(Ap, np.ones(2))


@pytest.mark.parametrize("make", [
    lambda: generators.random_unsym(60, 0.08, seed=3),
    lambda: generators.circuit_like(80, seed=4),
    lambda: generators.laplacian_2d(7),
])
def test_sparseinv_matches_reference(make):
    Ar, Ap = _pair(make())
    Zr, Zpr = ref_sparseinv(Ar)
    Zp, Zpp = port_sparseinv(Ap)
    assert (Zpr != Zpp).nnz == 0
    diff = np.abs((Zr - Zp).toarray()).max()
    assert diff <= 1e-12 * np.abs(Zr.toarray()).max()
    # and the subset is inv(A)'s
    inv = np.linalg.inv(Ap.to_scipy().toarray())
    mask = Zpp.toarray().astype(bool)
    assert np.abs(np.where(mask, Zp.toarray() - inv, 0)).max() <= \
        1e-10 * np.abs(inv).max()


def _lines(common):
    out = []
    common.print_func = out.append
    return out


@pytest.mark.parametrize("singletons", [True, False])
def test_report_functions_print_the_reference_text(singletons):
    A = generators.random_unsym(50, 0.08, seed=23)
    Ar, Ap = _pair(A)
    texts = []
    for lu, common, csc, kw in ((ref_lu, ref_common(), Ar, {}),
                                (port_lu, port_common(), Ap,
                                 dict(device="cpu"))):
        lines = _lines(common)
        common.lu.singletons = singletons
        S = lu.umf_symbolic(csc, common)
        num = lu.umf_numeric(csc, S, common, **kw)
        lu.report.report_status(common)
        lu.report.report_control(common)
        lu.report.report_symbolic(S, common)
        lu.report.report_numeric(num, common)
        lu.report.report_perm(S.a_perm_rows, common)
        lu.report.report_vector(np.arange(5.0) - 2, common)
        common.print_level = 3
        lu.report.report_matrix(csc, common)
        # timings differ run to run; every other info entry must agree
        common.info = {k: v for k, v in common.info.items()
                       if "time" not in k}
        lu.report.report_info(common)
        texts.append(lines)
    assert texts[0] == texts[1]
    assert any("umf symbolic" in t for t in texts[1])


def test_check_module_is_the_reference():
    A = generators.random_spd(20, 0.2, seed=7)
    Ar, Ap = _pair(A)
    fr, fp = ref_simplicial(Ar), port_simplicial(Ap)
    for name, args_r, args_p in (
            ("check_sparse", (Ar,), (Ap,)),
            ("check_factor", (fr,), (fp,)),
            ("check_perm", (fr.perm, 20), (fp.perm, 20)),
            ("check_perm", ([0, 0, 1], 3), ([0, 0, 1], 3)),
            ("check_parent", (fr.symbolic.parent,), (fp.symbolic.parent,)),
            ("check_parent", ([2, 0, -1],), ([2, 0, -1],)),
            ("check_triplet", (Ar.to_triplet(),), (Ap.to_triplet(),))):
        got = getattr(port_core, name)(*args_p)
        assert got == getattr(ref_core, name)(*args_r), name
        assert isinstance(got, bool)
    texts = []
    for core, csc, f, common in ((ref_core, Ar, fr, ref_common()),
                                 (port_core, Ap, fp, port_common())):
        lines = _lines(common)
        for level in (0, 1, 3, 4):
            common.print_level = level
            core.print_sparse(csc, "A", common)
            core.print_factor(f, "L", common)
            core.print_perm(f.perm, "p", common)
        common.info = {"lnz": 7}
        core.print_common(common)
        texts.append(lines)
    assert texts[0] == texts[1] and texts[1]
