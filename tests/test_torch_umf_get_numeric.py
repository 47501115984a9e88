"""The port's UMF LU factor as a caller reads it back, and its spans, on
the CPU in float64: ``umf_get_numeric`` gives L, U, P, Q, Rs and Cs with
P (R^-1 A) Q C^-1 = L U within 1e-12 (the symmetric strategy, the
unsymmetric one with its matching and column scaling, and block pivots
that move rows); a BTF numeric has no such factor; ``umf_solve`` with
refinement agrees with a dense float64 ``torch.linalg.solve`` on the
value sets the benchmark's refactor mix makes; and one ``umf_numeric``
and one ``umf_solve`` record each of their spans as often as they run."""
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from suitesparse_tpu_torch.io.generators import cd3d
from suitesparse_tpu_torch import lu
from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.core.sparse import SparseCSC
from suitesparse_tpu_torch.core.status import SparseError, Status
from suitesparse_tpu_torch.io import generators
from suitesparse_tpu_torch.utils import trace

from test_torch_umfpack import btf_matrix

TOL = 1e-12
BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"


def _pivoting(n=120, seed=5):
    """A symmetric pattern whose values put a larger entry below the
    diagonal of every column, factored with the symmetric strategy (rows
    kept in place), so the fronts' partial pivoting moves rows."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=0.06, random_state=rng, format="csc")
    pat = ((M + M.T + sp.eye(n, k=-1) + sp.eye(n, k=1)) != 0).astype(float)
    pat = sp.csc_matrix(pat + sp.eye(n))
    C = pat.tocoo()
    vals = rng.uniform(0.5, 1.5, C.nnz)
    vals[C.row == C.col] *= 0.05
    vals[C.row == C.col + 1] *= 4.0
    return SparseCSC.from_scipy(sp.csc_matrix((vals, (C.row, C.col)),
                                              shape=(n, n)))


# name -> (matrix, Common.lu options, strategy umf_symbolic picks)
CASES = {
    "cd3d_6": (lambda: cd3d(6), {}, "symmetric"),
    "random_unsym": (lambda: generators.random_unsym(200, 0.05, seed=3),
                     dict(singletons=False), "unsymmetric"),
    "block_pivots": (_pivoting, dict(singletons=False,
                                     strategy="symmetric"), "symmetric"),
}


def _factor(A, opts):
    cm = default_common()
    for k, v in opts.items():
        setattr(cm.lu, k, v)
    S = lu.umf_symbolic(A, cm)
    return cm, S, lu.umf_numeric(A, S, cm, device="cpu")


def _moved_rows(num) -> int:
    return sum(int((p.numpy() != np.arange(p.shape[1])).sum())
               for level in num.pivs for p in level)


@pytest.mark.parametrize("name", list(CASES))
def test_get_numeric_gives_the_factored_matrix(name):
    make, opts, strategy = CASES[name]
    A = make()
    cm, S, num = _factor(A, opts)
    assert S.strategy == strategy and num.ok
    f = lu.umf_get_numeric(num)
    n = A.nrow
    for key in ("P", "Q"):
        assert np.array_equal(np.sort(f[key]), np.arange(n))
    L, U = f["L"], f["U"]
    assert L.dtype == U.dtype == np.float64
    assert sp.triu(L, 1).nnz == 0 and sp.tril(U, -1).nnz == 0
    assert np.array_equal(L.diagonal(), np.ones(n))
    M = (A.to_scipy().toarray() / f["Rs"][:, None])[f["P"]][:, f["Q"]] \
        / f["Cs"][None, :]
    err = np.abs(M - (L @ U).toarray()).max() / np.abs(M).max()
    assert err <= TOL, err
    if name == "random_unsym":
        assert not np.allclose(f["Cs"], 1.0)
    if name == "block_pivots":
        # the relation holds because the descendants' L rows follow the
        # block pivots: without them it does not
        assert _moved_rows(num) > 0
        assert not np.array_equal(f["P"], S.a_perm_rows)
    else:
        assert np.array_equal(f["P"], S.a_perm_rows)


def test_get_numeric_raises_on_a_btf_numeric():
    A = btf_matrix()
    cm, S, num = _factor(A, {})
    assert S.strategy == "btf" and num.bnums is not None
    with pytest.raises(SparseError) as got:
        lu.umf_get_numeric(num)
    assert got.value.status == Status.NOT_AVAILABLE


def _traffic():
    """The benchmark's traffic generator, loaded from its file."""
    path = BENCH / "harness" / "traffic.py"
    spec = importlib.util.spec_from_file_location("bench_traffic", path)
    mod = importlib.util.module_from_spec(spec)
    # its dataclass looks its module up by name
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("value_set", [0, 1, 2])
def test_umf_solve_matches_a_dense_solve_on_the_refactor_mix(value_set):
    traffic = _traffic()
    mix = traffic.full(json.loads((BENCH / "mixes" / "refactor.json")
                                  .read_text()), "refactor")
    mix["value_sets"] = 3
    A0 = cd3d(6).to_scipy().tocsc()
    pools = traffic.make_pools(A0, mix, seed=2 ** 31 + 77)
    data = pools.values[value_set]
    assert not np.array_equal(data, A0.data)
    A = SparseCSC(A0.indptr, A0.indices, data, A0.shape)
    cm, S, num = _factor(A, {})
    b = pools.rhs[value_set]
    x = lu.umf_solve(num, b, A=A, common=cm)
    dense = torch.as_tensor(A.to_scipy().toarray(), dtype=torch.float64)
    want = torch.linalg.solve(dense, torch.as_tensor(b)).numpy()
    assert np.abs(x - want).max() <= TOL * np.abs(want).max()


def _count(name) -> int:
    got = trace.snapshot().get(name)
    return got["count"] if got else 0


NUMERIC_CHILDREN = ("values", "upload", "program", "check")
SOLVE_CHILDREN = ("upload", "program", "download")


def test_one_numeric_and_one_solve_record_their_spans():
    A = cd3d(5)
    cm = default_common()
    S = lu.umf_symbolic(A, cm)
    trace.reset()
    try:
        num = lu.umf_numeric(A, S, cm, device="cpu")
        assert _count("umf.numeric") == 1
        for child in NUMERIC_CHILDREN:
            assert _count("umf.numeric." + child) == 1, child
        calls = trace.snapshot()["umf.numeric.program"]["calls"]
        assert calls[0].parent == "umf.numeric" and calls[0].d2d > 0
        assert trace.snapshot()["umf.numeric.upload"]["h2d"] == \
            8 * len(S.a_scatter_L)
        b = np.random.default_rng(3).standard_normal(A.nrow)
        lu.umf_solve(num, b, A=A, refine=2, common=cm)
        assert _count("umf.solve") == 1
        assert _count("umf.solve.bind") == 1
        assert trace.snapshot()["umf.solve.bind"]["d2d"] > 0
        residuals = _count("umf.solve.residual")
        assert 1 <= residuals <= 2
        # a solve program call per solve: the first solve and one a step
        solves = _count("umf.solve.program")
        assert solves % 2 == 0 and 1 <= solves // 2 <= residuals + 1
        for child in SOLVE_CHILDREN:
            assert _count("umf.solve." + child) == solves, child
        assert _count("umf.solve.escalate") == 0
        # the same numeric again: nothing to bind
        lu.umf_solve(num, b, A=A, refine=2, common=cm)
        assert _count("umf.solve") == 2 and _count("umf.solve.bind") == 1
    finally:
        trace.reset()


def test_the_klu_fallback_is_a_span_of_its_own():
    A = cd3d(5)
    cm = default_common()
    S = lu.umf_symbolic(A, cm)
    num = lu.umf_numeric(A, S, cm, device="cpu")
    b = np.random.default_rng(4).standard_normal(A.nrow)
    # a target below every omega a solve can reach forces the fallback
    cm.lu.escalate_omega = 1e-300
    trace.reset()
    try:
        x = lu.umf_solve(num, b, A=A, refine=1, common=cm)
        assert _count("umf.solve.escalate") == 1
        assert trace.snapshot()["umf.solve.escalate"]["calls"][0].parent \
            == "umf.solve"
        assert cm.info.get("umf_escalated") is True
        r = b - A.to_scipy() @ x
        assert np.abs(r).max() <= 1e-10 * np.abs(b).max()
    finally:
        trace.reset()


def test_symbolic_and_plan_spans():
    A = cd3d(5)
    trace.reset()
    try:
        S = lu.umf_symbolic(A, default_common())
        got = trace.snapshot()
        assert got["umf.symbolic"]["count"] == 1
        for name in ("cholesky.analyze", "plan.build_plan", "plan.umf_maps"):
            assert got[name]["calls"][0].parent.startswith("umf.symbolic"), \
                name
        lu.umf_numeric(A, S, device="cpu")
        lu.umf_numeric(A, S, device="cpu")
        # the device maps are made once per pattern and device
        assert _count("plan.umf_device_maps") == 1
        assert _count("umf.numeric") == 2
    finally:
        trace.reset()
