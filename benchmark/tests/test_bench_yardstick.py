"""The yardstick on the CPU: the traffic pools, the copied block_chol
counts, the trace reduction, the judge, and the import rules."""
import ast
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp

import bench_support as bs
from harness import counts, tracing, traffic
from reference import backward_error

MIX = dict(step="refactor_solve", setup=["refactor_solve"], value_sets=4,
           offdiag_scale=[0.5, 1.5], rhs_pool=3, rhs_width=1, trace_steps=2)


def _generator(name):
    from harness.spec import load_module
    return load_module(bs.BENCH / "generators" / f"{name}.py", "test_gen_")


def _convection_diffusion(m):
    T = sp.diags([-1.3, 4.2, -0.7], [-1, 0, 1], shape=(m, m))
    I = sp.identity(m)
    return sp.csc_matrix(sp.kron(I, T) + sp.kron(T, I))


@pytest.mark.parametrize("make", [
    lambda: _generator("laplacian_3d").make(6),
    lambda: _convection_diffusion(9)], ids=["laplacian_3d", "unsymmetric"])
def test_value_pools_stay_spd_and_repeat_per_seed(make):
    A = make()
    symmetric = abs(A - A.T).max() == 0
    a = traffic.make_pools(A, MIX, bs.BIG_SEED)
    b = traffic.make_pools(A, MIX, bs.BIG_SEED)
    c = traffic.make_pools(A, MIX, bs.BIG_SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a.values, b.values))
    assert np.array_equal(a.rhs, b.rhs)
    assert len(c.values) == len(a.values) and c.rhs.shape == a.rhs.shape
    assert not np.array_equal(a.values[0], c.values[0])
    excess0 = A.diagonal() - (abs(A).sum(axis=1).A1 - A.diagonal())
    for v in a.values:
        B = sp.csc_matrix((v, A.indices, A.indptr), shape=A.shape)
        off = abs(B).sum(axis=1).A1 - B.diagonal()
        assert np.allclose(B.diagonal() - off, excess0)
        if symmetric:
            assert abs(B - B.T).max() == 0
            assert np.linalg.eigvalsh(B.toarray()).min() > 0
        else:
            # strictly diagonally dominant by rows: every eigenvalue in the
            # right half-plane (Gershgorin), so nonsingular
            assert abs(B - B.T).max() > 0 and excess0.min() > 0
            assert np.linalg.eigvals(B.toarray()).real.min() > 0
        # the off-diagonal factors lie in the mix's range
        ratio = np.abs(v / np.where(A.data == 0, 1, A.data))
        offd = A.indices != np.repeat(np.arange(A.shape[0]),
                                      np.diff(A.indptr))
        assert ratio[offd].min() >= 0.5 and ratio[offd].max() <= 1.5


def test_a_mix_gets_its_defaults_and_keeps_its_own_keys():
    mix = traffic.full(dict(step="solve", setup=[], trace_steps=3,
                            refine_steps=2), "m")
    assert mix["value_sets"] == 1 and mix["rhs_width"] == 1
    assert mix["refine_steps"] == 2
    pools = traffic.make_pools(_generator("laplacian_3d").make(3), mix, 7)
    assert len(pools.values) == 1 and pools.rhs.shape == (16, 27)
    assert pools.mix["refine_steps"] == 2
    with pytest.raises(ValueError, match="missing"):
        traffic.full(dict(step="solve", trace_steps=3), "m")


def test_block_chol_counts_agree_with_the_plan():
    from suitesparse_tpu_torch.cholesky import pf
    from suitesparse_tpu_torch.cholesky.api import analyze
    from suitesparse_tpu_torch.cholesky.super_numeric import build_plan
    from suitesparse_tpu_torch.cholesky.supernodal import super_symbolic
    from suitesparse_tpu_torch.core.common import default_common
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    A = SparseCSC.from_scipy(_generator("laplacian_3d").make(12))
    cm = default_common()
    sym = analyze(A, cm)
    pfp = build_plan(super_symbolic(A, sym, cm)).pf_plan(cm)
    got = counts.block_chol_shapes(pfp.fmeta, pfp.instr_cls,
                                   pf._POTRF_MAXNP)
    assert got == pf.block_chol_shapes(pfp) and sum(got.values()) > 0
    # the bound of one launch: bytes at small W, operations at large Np
    W, Np = 3, 64
    assert counts.block_chol_bytes(W, Np) == (2 * W * Np * Np + W * Np) * 4
    assert counts.block_chol_flops(W, Np) == W * Np ** 3 / 3
    least = counts.block_chol_least_s({(W, Np): 2})
    assert least == 2 * max(W * Np ** 3 / 3 / 67e12,
                            (2 * W * Np * Np + W * Np) * 4 / 3.35e12)


def test_a_share_above_the_peak_is_refused():
    assert counts.share_of_peak(1.0, 1.0, "x") == 100.0
    assert counts.share_of_peak(1.04, 1.0, "x") == pytest.approx(104.0)
    with pytest.raises(RuntimeError, match="above"):
        counts.share_of_peak(1.06, 1.0, "x")


def _ev(cat, name, ts, dur=None, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "tid": 1}
    if dur is not None:
        e["dur"] = dur
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction():
    ev = [_ev("user_annotation", "bench.window", 0, 100),
          _ev("user_annotation", "bench.refactorize", 0, 40),
          _ev("user_annotation", "bench.solve", 50, 40),
          _ev("user_annotation", "other", 0, 100),
          _ev("cuda_runtime", "cudaGraphLaunch", 2, 1, corr=1),
          _ev("cuda_runtime", "cudaMemcpyAsync", 51, 1, corr=2),
          _ev("cuda_runtime", "cudaGraphLaunch", 55, 1, corr=3),
          _ev("kernel", "void block_chol_panels<float>", 5, 10, corr=1),
          _ev("kernel", "ampere_sgemm_128x64", 10, 20, corr=1),
          _ev("gpu_memcpy", "Memcpy HtoD", 52, 2, corr=2),
          _ev("kernel", "vectorized_elementwise_kernel", 60, 20, corr=3),
          # past the window's end: left out
          _ev("kernel", "late", 120, 5, corr=3)]
    s = tracing.reduce_trace(ev)
    assert s["window_us"] == 100 and s["ops"] == 4 and s["launched"] == 4
    assert s["calls"] == {"refactorize": 1, "solve": 1}
    assert s["busy_us"] == 25 + 2 + 20
    assert s["graph_busy_us"] == {"refactorize": 25, "solve": 20}
    assert s["kernel_n"]["refactorize"] == {"block_chol": 1, "gemm": 1}
    assert s["kernel_us"]["refactorize"]["block_chol"] == 10
    # idle: 0-5 and 30-40 in refactorize, 40-50 between calls, the rest
    # of 50-90 in solve, 90-100 after
    assert s["idle_us"] == {"refactorize": 15, "harness": 20, "solve": 18}
    b = tracing.breakdown(s)
    assert b["device_ops"][0] == ["gemm", 20e-6]
    assert b["idle_gaps"][0] == ["harness", 20e-6]
    with pytest.raises(RuntimeError, match="window"):
        tracing.reduce_trace(ev[1:])


def test_backward_errors():
    rng = np.random.default_rng(bs.BIG_SEED)
    A = _generator("laplacian_3d").make(5)
    n = A.shape[0]
    Ad = A.toarray()
    X = rng.standard_normal((3, n))          # one solution a row
    B = X @ Ad
    assert backward_error.solve_berr(A, X, B).max() < 1e-15
    Xbad = X.copy()
    Xbad[1, 0] += 1e-3
    e = backward_error.solve_berr(A, Xbad, B)
    assert e[1] > 1e-5 and max(e[0], e[2]) < 1e-15
    Xnan = X.copy()
    Xnan[2, 0] = np.nan
    assert backward_error.solve_berr(A, Xnan, B)[2] == np.inf
    perm = rng.permutation(n)
    L = np.linalg.cholesky(Ad[np.ix_(perm, perm)])
    Z = rng.standard_normal((n, 4))
    assert backward_error.factor_berr(A, perm, sp.csc_matrix(L), Z) < 1e-15
    L[3, 3] *= 1.001
    assert backward_error.factor_berr(A, perm, sp.csc_matrix(L), Z) > 1e-5
    # a factor of another ordering is not this one's
    L0 = np.linalg.cholesky(Ad)
    assert backward_error.factor_berr(A, perm, sp.csc_matrix(L0), Z) > 1e-3
    # L D L', L unit lower
    L[3, 3] /= 1.001
    d = np.diag(L).copy()
    Lu = sp.csc_matrix(L / d)
    assert backward_error.factor_berr(A, perm, Lu, Z, D=d * d) < 1e-14
    d[2] *= 1.001
    assert backward_error.factor_berr(A, perm, Lu, Z, D=d * d) > 1e-5


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(bs.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        got = _imports(f) & {"jax", "jaxlib", "flax", "suitesparse_tpu"}
        assert not got, f"{f} imports {got}"
    # the harness names the program by its whole top-level name
    assert "suitesparse_tpu_torch" in _imports(bs.BENCH / "solvers" /
                                               "cholesky.py")
    for f in sorted((bs.BENCH / "reference").rglob("*.py")):
        assert "suitesparse_tpu_torch" not in _imports(f), f
        assert _imports(f) <= {"__future__", "warnings", "numpy", "scipy",
                               "torch"}, f


def test_the_run_checks_loaded_modules_by_whole_name(monkeypatch):
    import sys
    from harness import cli
    monkeypatch.setitem(sys.modules, "suitesparse_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert cli.forbidden_modules() == ["jax"]
