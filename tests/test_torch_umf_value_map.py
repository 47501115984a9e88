"""The UMF LU's value map (lu/multifrontal._umf_value_map) on the CPU in
float64 and float32: the values the LU program reads are those of the
SciPy chain that scaled, permuted and sorted them on every call before
the map (kept here as the reference), bit for bit, with the same row and
column scalings; the map is made once per pattern and rebuilt for another
layout; a matrix of another pattern is refused; and refactorizations
through a reused map still match the JAX reference."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.lu as ref_lu
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC

from suitesparse_tpu_torch import lu
from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.core.sparse import SparseCSC
from suitesparse_tpu_torch.core.status import SparseError, Status
from suitesparse_tpu_torch.io import generators
from suitesparse_tpu_torch.lu import multifrontal
from suitesparse_tpu_torch.lu.klu import _row_scale
from suitesparse_tpu_torch.utils import trace

from test_torch_umfpack import CASES, TOL, _commons, _rel, _same_numeric


def chain(A, S, scale, dtype):
    """(B2's values, Rs, Cs) as umf_numeric made them before the value
    map: SciPy row sums, then scale, permute, sort and scale the columns
    of a copy of A."""
    Rs = _row_scale(A, scale)
    Asc = A.to_scipy().tocsc(copy=True)
    Asc.data = Asc.data * (1.0 / Rs)[Asc.indices]
    B2 = Asc[S.a_perm_rows, :][:, S.a_perm_cols].tocsc()
    B2.sort_indices()
    if S.strategy != "symmetric" and scale != "none":
        Cs = np.abs(B2.diagonal())
        Cs[(Cs == 0) | ~np.isfinite(Cs)] = 1.0
        B2.data = B2.data * np.repeat(1.0 / Cs, np.diff(B2.indptr))
    else:
        Cs = np.ones(S.n)
    return B2.data.astype(dtype), Rs, Cs


def _matrix(kind, seed=0):
    """cd3d_6 or a random unsymmetric matrix with new values, every 9th a
    stored zero; "unsorted" reverses each column's entries."""
    base = (generators.cd3d(6) if kind == "cd3d"
            else generators.random_unsym(150, 0.05, seed=3))
    rng = np.random.default_rng(seed)
    data = base.data * rng.uniform(0.5, 2.0, base.nnz)
    data[::9] = 0.0
    return SparseCSC(base.indptr, base.indices, data, base.shape)


def _unsorted(A):
    order = np.concatenate([np.arange(A.indptr[j + 1] - 1, A.indptr[j] - 1,
                                      -1) for j in range(A.ncol)])
    return SparseCSC(A.indptr, A.indices[order], A.data[order], A.shape,
                     sorted=False)


def _symbolic(A, strategy, scale):
    cm = default_common()
    cm.lu.singletons = False
    cm.lu.strategy = strategy
    cm.lu.scale = scale
    return cm, lu.umf_symbolic(A, cm)


class _Reads:
    """umf_program wrapped so that the values each call reads are kept."""

    def __init__(self, monkeypatch):
        self.values = []
        real = multifrontal.umf_program

        def wrapped(S, dtype, device):
            prog = real(S, dtype, device)

            def call(vj):
                self.values.append(vj.clone())
                return prog(vj)
            return call
        monkeypatch.setattr(multifrontal, "umf_program", wrapped)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("scale", ["sum", "max", "none"])
@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
@pytest.mark.parametrize("kind,strategy", [("cd3d", "symmetric"),
                                           ("cd3d", "unsymmetric"),
                                           ("random", "unsymmetric")])
def test_program_reads_the_chains_values(monkeypatch, kind, strategy,
                                         layout, scale, dtype):
    A = _matrix(kind)
    if layout == "unsorted":
        A = _unsorted(A)
    cm, S = _symbolic(A, strategy, scale)
    assert S.strategy == strategy
    reads = _Reads(monkeypatch)
    num = lu.umf_numeric(A, S, cm, dtype=dtype, device="cpu")
    want, Rs, Cs = chain(A, S, scale, dtype)
    got = reads.values[-1].numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    assert np.array_equal(num.Rs, Rs) and np.array_equal(num.Cs, Cs)
    assert np.array_equal(num.Rs, _row_scale(A, scale))


def test_complex_values_match_the_chain(monkeypatch):
    A = SparseCSC.from_scipy(sp.random(80, 80, density=0.06,
                                       random_state=7, format="csc")
                             * (1 + 2j) + sp.eye(80) * (3 - 1j))
    cm, S = _symbolic(A, "unsymmetric", "sum")
    reads = _Reads(monkeypatch)
    num = lu.umf_numeric(A, S, cm, device="cpu")
    want, Rs, Cs = chain(A, S, "sum", np.complex128)
    assert torch.equal(reads.values[-1], torch.from_numpy(want))
    assert np.array_equal(num.Rs, Rs) and np.array_equal(num.Cs, Cs)


def _count(name) -> int:
    got = trace.snapshot().get(name)
    return got["count"] if got else 0


@pytest.mark.parametrize("strategy", ["symmetric", "unsymmetric"])
def test_the_map_is_made_once_per_pattern(monkeypatch, strategy):
    A = _matrix("cd3d")
    cm, S = _symbolic(A, strategy, "sum")
    reads = _Reads(monkeypatch)
    trace.reset()
    try:
        for seed in range(5):
            Ai = _matrix("cd3d", seed)
            # fresh values on the one pattern's index arrays
            Ai = SparseCSC(A.indptr, A.indices, Ai.data, A.shape)
            lu.umf_numeric(Ai, S, cm, device="cpu")
            assert torch.equal(reads.values[-1], torch.from_numpy(
                chain(Ai, S, "sum", np.float64)[0]))
        assert _count("plan.umf_value_map") == 1
        assert _count("umf.numeric.values") == 5
        assert _count("umf.numeric.gather") == 5
        assert {c.parent for c in trace.snapshot()["plan.umf_value_map"][
            "calls"]} == {"umf.numeric/umf.numeric.values"}
    finally:
        trace.reset()


def test_equal_arrays_hit_and_another_layout_rebuilds(monkeypatch):
    A = _matrix("cd3d")
    cm, S = _symbolic(A, "unsymmetric", "sum")
    reads = _Reads(monkeypatch)
    trace.reset()
    try:
        first = lu.umf_numeric(A, S, cm, device="cpu")
        # equal pattern arrays that are new objects: a hit
        again = lu.umf_numeric(SparseCSC(A.indptr.copy(), A.indices.copy(),
                                         A.data.copy(), A.shape), S, cm,
                               device="cpu")
        assert _count("plan.umf_value_map") == 1
        assert torch.equal(again.Lb, first.Lb)
        # the same matrix with each column's entries reversed: a miss,
        # and the same factor
        U = _unsorted(A)
        other = lu.umf_numeric(U, S, cm, device="cpu")
        assert _count("plan.umf_value_map") == 2
        assert torch.equal(reads.values[-1], torch.from_numpy(
            chain(U, S, "sum", np.float64)[0]))
        assert torch.equal(other.Lb, first.Lb)
        assert torch.equal(other.Ub, first.Ub)
        # back to the first layout: rebuilt again
        lu.umf_numeric(A, S, cm, device="cpu")
        assert _count("plan.umf_value_map") == 3
    finally:
        trace.reset()


def test_another_pattern_is_refused():
    A = _matrix("cd3d")
    cm, S = _symbolic(A, "symmetric", "sum")
    lu.umf_numeric(A, S, cm, device="cpu")
    M = A.to_scipy().tolil()
    M[0, A.ncol - 1] = 1.0
    B = SparseCSC.from_scipy(M.tocsc())
    with pytest.raises(SparseError) as err:
        lu.umf_numeric(B, S, cm, device="cpu")
    assert err.value.status == Status.INVALID
    assert "pattern is not the symbolic's" in str(err.value)


@pytest.mark.parametrize("name", [n for n in CASES if n != "btf"] + ["btf"])
def test_refactorizations_match_the_reference(name):
    """A second value set on new index arrays (the map reused, and for the
    BTF path each block's map rebuilt or reused) against the JAX
    package's numeric and refined solve of the same matrix."""
    make, opts, _ = CASES[name]
    A0 = make()
    rc, pc = _commons(opts)
    Sr = ref_lu.umf_symbolic(RefCSC(A0.indptr, A0.indices, A0.data,
                                    A0.shape), rc)
    Sp = lu.umf_symbolic(A0, pc)
    lu.umf_numeric(A0, Sp, pc, device="cpu")
    rng = np.random.default_rng(17)
    data = A0.data * rng.uniform(0.5, 2.0, A0.nnz)
    Ap = SparseCSC(A0.indptr.copy(), A0.indices.copy(), data, A0.shape)
    Ar = RefCSC(Ap.indptr, Ap.indices, Ap.data, Ap.shape)
    nr = ref_lu.umf_numeric(Ar, Sr, rc)
    np_ = lu.umf_numeric(Ap, Sp, pc, device="cpu")
    assert np_.ok
    _same_numeric(nr, np_)
    b = rng.standard_normal((Ap.ncol, 2))
    xr = ref_lu.umf_solve(nr, b, "A", A=Ar)
    xp = lu.umf_solve(np_, b, "A", A=Ap)
    assert _rel(xp, xr) <= TOL
