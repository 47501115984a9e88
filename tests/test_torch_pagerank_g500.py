"""PageRank on the benchmark's Graph500 Kronecker graph (kron_g500), on
the CPU in float64 at scale <= 12: the port's ``graphblas.pagerank``
against the benchmark's plain reference (``benchmark/reference/
pagerank.py``), the compact device layout against the per-arc weights it
replaced, the generator's invariants, and the spans and counters of a
call."""
import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from suitesparse_tpu_torch.core.sparse import SYM_LOWER, SparseCSC
from suitesparse_tpu_torch.graphblas import compact_graph, pagerank
from suitesparse_tpu_torch.graphblas import algorithms as alg
from suitesparse_tpu_torch.utils import trace

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
CPU = torch.device("cpu")
PR = "graphblas.pagerank"
KRON = dict(edgefactor=16, a=0.57, b=0.19, c=0.19)


def _bench(kind, name):
    """The benchmark's file ``<kind>/<name>.py`` as a module of its own."""
    key = f"pr_bench_{kind}_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, BENCH / kind / f"{name}.py")
        sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[key])
    return sys.modules[key]


def _kron(scale, seed=5):
    """The strictly lower triangle of the kron graph at ``scale``."""
    return _bench("generators", "kron_g500").make(scale=scale, seed=seed,
                                                  **KRON)


def _graph(L):
    """The graph as the benchmark's front end hands it to the program."""
    return SparseCSC(L.indptr, L.indices, None, L.shape, stype=SYM_LOWER)


def _ref():
    return _bench("reference", "pagerank")


@pytest.mark.parametrize("scale,seed", [(10, 1), (12, 7)])
def test_pagerank_matches_the_benchmark_reference(scale, seed):
    """The port's ranks within 1e-12 (L1) of the float64 reference's
    iterate at the same iteration count, and the reference's own stop."""
    ref = _ref()
    L = _kron(scale, seed)
    G = _graph(L)
    before = trace.counts()
    r = pagerank(G, ref.DAMPING, ref.TOL, ref.MAX_ITER, device="cpu")
    k = trace.counts()[PR + ".iterations"] - before.get(
        PR + ".iterations", 0)
    assert r.dtype == np.float64 and r.shape == (2 ** scale,)
    case = types.SimpleNamespace(A0=L, answers=[(k, r)], device=CPU)
    got = ref.judge(case)
    assert got["values"]["pr_iter_gap"] == 0
    assert got["values"]["pr_l1_err"] <= 1e-12
    assert 2 <= k < ref.MAX_ITER
    # one iteration more or less is a different answer
    g = ref.Graph(L, CPU)
    x = torch.full((g.n,), 1.0 / g.n, dtype=torch.float64)
    for _ in range(k - 1):
        x = g.step(x)
    assert float((torch.as_tensor(r) - x).abs().sum()) > 1e3 * 1e-12


def _weighted(n=600, seed=3):
    """A directed graph with values (a self-loop at 0, no out-arc from
    the last 5 vertices) and its pattern-only twin."""
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, 0.01, random_state=rng, format="lil")
    S[0, 0] = 1.0
    S[n - 5:, :] = 0
    S = sp.csc_matrix(S)
    S.eliminate_zeros()
    S.sort_indices()
    S.data[:] = rng.uniform(0.5, 2.0, S.nnz)
    return (SparseCSC.from_scipy(S),
            SparseCSC(S.indptr, S.indices, None, S.shape))


@pytest.mark.parametrize("valued", [True, False])
@pytest.mark.parametrize("tol,max_iter", [(1e-9, 100), (0.0, 11)])
def test_compact_layout_matches_the_per_arc_weights(valued, tol, max_iter):
    """The compact layout's ranks and iteration count equal, bit for bit,
    the loop on per-arc weights 1 / outdeg(source) (the layout it
    replaced), on a graph with values and on its pattern; the values never
    reach the device."""
    A = _weighted()[0 if valued else 1]
    rows, cols, _ = alg._coo_arrays(A, CPU)
    outdeg = torch.clamp(torch.bincount(rows, minlength=A.nrow).double(),
                         min=1.0)
    want, it = alg._pagerank_loop(rows, cols, 1.0 / outdeg[rows], A.nrow,
                                  0.85, tol, max_iter)
    got, its = alg._pagerank(A, 0.85, tol, max_iter, CPU)
    assert its == it and torch.equal(got, want)
    g = compact_graph(A, "cpu")
    assert isinstance(g, alg.CompactGraph) and g.rows.dtype == torch.int32
    assert torch.equal(g.offsets, torch.as_tensor(A.indptr))
    assert torch.equal(g.rows.long(), rows)
    assert g.dinv.dtype == torch.float64 and g.arcs == A.nnz
    assert not any(isinstance(v, torch.Tensor) and v.numel() == A.nnz
                   and v.is_floating_point() for v in vars(g).values())


@pytest.mark.parametrize("stype", [SYM_LOWER, 1])
def test_a_stored_triangle_is_expanded_on_the_device(stype, monkeypatch):
    """A symmetric matrix stored by one triangle (a diagonal entry being
    one self-loop) expands to the full pattern's CSC, whatever the
    import's chunk; its ranks equal the full matrix's bit for bit."""
    monkeypatch.setattr(alg, "IMPORT_CHUNK", 97)
    rng = np.random.default_rng(11)
    S = sp.random(400, 400, 0.03, random_state=rng, format="csc")
    S = sp.csc_matrix(S + S.T + sp.diags((rng.random(400) < 0.2) * 1.0))
    S.eliminate_zeros()
    S.sort_indices()
    T = sp.csc_matrix(sp.tril(S) if stype < 0 else sp.triu(S))
    T.sort_indices()
    half = SparseCSC(T.indptr, T.indices, None, T.shape, stype=stype)
    full = SparseCSC(S.indptr, S.indices, None, S.shape)
    g = compact_graph(half, "cpu")
    assert np.array_equal(g.offsets.numpy(), S.indptr)
    assert np.array_equal(g.rows.numpy(), S.indices)
    a, ia = alg._pagerank(half, 0.85, 1e-10, 100, CPU)
    b, ib = alg._pagerank(full, 0.85, 1e-10, 100, CPU)
    assert ia == ib and torch.equal(a, b)


def test_the_generator_invariants():
    """Strictly lower (no self-loop), no duplicate, symmetric once the
    program expands it, float32 ones with int32 indices, the same graph
    for a seed and another for another seed; the degrees of a power law:
    hubs far above the mean and isolated vertices."""
    L = _kron(11, seed=5)
    n = 2 ** 11
    assert L.shape == (n, n) and L.dtype == np.float32
    assert L.indices.dtype == np.int32 and L.has_sorted_indices
    assert sp.triu(L).nnz == 0 and np.all(L.data == 1)
    C = L.tocoo()
    key = C.row.astype(np.int64) * n + C.col
    assert len(np.unique(key)) == L.nnz
    g = compact_graph(_graph(L), "cpu")
    F = (L + L.T).tocsc()
    F.sort_indices()
    assert np.array_equal(g.offsets.numpy(), F.indptr)
    assert np.array_equal(g.rows.numpy(), F.indices)
    assert g.arcs == 2 * L.nnz
    A = sp.csc_matrix((np.ones(g.arcs), g.rows.numpy(), g.offsets.numpy()),
                      shape=(n, n))
    assert abs(A - A.T).nnz == 0
    again = _kron(11, seed=5)
    assert np.array_equal(again.indptr, L.indptr) and np.array_equal(
        again.indices, L.indices)
    other = _kron(11, seed=6)
    assert other.nnz != L.nnz or not np.array_equal(other.indices,
                                                    L.indices)
    deg = np.diff(F.indptr)
    assert deg.max() > 20 * deg.mean() and 0.1 < np.mean(deg == 0) < 0.5


def test_spans_and_counters_of_a_call():
    """A call's spans (import on the first call only, one program run and
    one flag read a loop-program run, one download) and counters
    (iterations the reference's, 8 predicated steps a program run)."""
    ref = _ref()
    L = _kron(10, seed=2)
    G = _graph(L)
    trace.reset()
    pagerank(G, ref.DAMPING, ref.TOL, ref.MAX_ITER, device="cpu")
    first = trace.counts()
    spans = trace.snapshot()
    assert spans[PR + ".import"]["count"] == 1
    assert spans[PR + ".import"]["h2d"] >= 8 * L.nnz
    pagerank(G, ref.DAMPING, ref.TOL, ref.MAX_ITER, device="cpu")
    got = trace.counts()
    spans = trace.snapshot()
    assert spans[PR + ".import"]["count"] == 1
    assert spans[PR]["count"] == spans[PR + ".download"]["count"] == 2
    runs = got[PR + ".program_runs"]
    assert runs == 2 * first[PR + ".program_runs"]
    assert spans[PR + ".program"]["count"] == spans[PR + ".sync"][
        "count"] == runs
    assert got[PR + ".steps_run"] == alg.LOOP_STEPS * runs
    k = first[PR + ".iterations"]
    assert got[PR + ".iterations"] == 2 * k
    assert -(-k // alg.LOOP_STEPS) == first[PR + ".program_runs"]
    case = types.SimpleNamespace(
        A0=L, answers=[(k, pagerank(G, ref.DAMPING, ref.TOL, ref.MAX_ITER,
                                    device="cpu"))], device=CPU)
    assert ref.judge(case)["values"]["pr_iter_gap"] == 0
    assert all(c.parent == PR for c in spans[PR + ".download"]["calls"])
