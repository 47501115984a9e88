"""The port's sparse QR on its least-squares path, on the CPU, against
plain dense PyTorch: qr_symbolic's NumPy maps against the per-entry loops
they replace, qr_factorize's value map, program and carried right-hand
side, and the R solve on the device (here the CPU), on the weighted
gradient systems of IRLS phase unwrapping (the benchmark's unwrap3d
configuration at 5^3 to 8^3)."""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.core.sparse import INDEX, SparseCSC
from suitesparse_tpu_torch.io.generators import grad3d, grad3d_tik
from suitesparse_tpu_torch.qr import spqr
from suitesparse_tpu_torch.utils import trace

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"


def _bench(kind, name):
    """The benchmark's file ``<kind>/<name>.py`` as a module of its own."""
    key = f"ls_bench_{kind}_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, BENCH / kind / f"{name}.py")
        sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[key])
    return sys.modules[key]


def _irls(nx, seed=0, dtype="float64"):
    """The benchmark's front end on unwrap3d at nx (its ``Driver``), the
    value sets and N(0, 1) vectors: two value sets drawn as the irls mix
    draws them."""
    L = _bench("generators", "grid_normal_3d").make(nx=nx, mu=0.1)
    drv = _bench("solvers", "spqr").Driver(
        L, {"dtype": dtype}, "cpu", _bench("harness", "tracing").Spans())
    rng = np.random.default_rng(seed)
    values = _bench("harness", "traffic").value_sets(L, 2, [0.01, 1.0], rng)
    drv.set_values(values)
    return drv, values, rng.standard_normal((2, L.shape[0]))


def test_the_least_squares_matrix_read_from_l_has_a_t_a_equal_to_l():
    drv, values, rho = _irls(5)
    L = drv.A0
    for v, data in enumerate(values):
        A = drv.matrices[v].to_scipy()
        assert A.shape == (3 * 4 * 25 + 125, 125)
        Lv = sp.csc_matrix((data, L.indices, L.indptr), shape=L.shape)
        assert abs(A.T @ A - Lv).max() <= 1e-14 * abs(Lv).max()
        b = drv.rhs_of(_Pools(rho), v, 0)
        assert np.all(b[300:] == 0) and np.abs(b).max() <= np.pi


class _Pools:
    def __init__(self, rho):
        self.rhs = rho


def _solve(drv, v, rho, dtype=None):
    """One IRLS solve through qr_factorize with b and the R solve: x in
    A's column order, with A and b."""
    A = drv.matrices[v]
    b = drv.rhs_of(_Pools(rho), v, v)
    if drv.S is None:
        drv.S = spqr.qr_symbolic(A)
    num = spqr.qr_factorize(A, drv.S, b=b, dtype=dtype or drv.dtype,
                            device="cpu")
    xq = spqr.qr_rsolve(num, num.qtb[:, 0])
    x = np.empty_like(xq)
    x[drv.S.sym.perm] = xq
    return x, A.to_scipy().toarray(), b, num


def _lstsq(A, b):
    At = torch.as_tensor(A)
    return torch.linalg.lstsq(At, torch.as_tensor(b)[:, None],
                              driver="gelsd").solution[:, 0].numpy()


@pytest.mark.parametrize("nx", [5, 6, 8])
def test_float64_path_matches_dense_lstsq(nx):
    """kappa(A) <= 35 (sigma_min >= mu = 0.1, sigma_max <= sqrt(12.01)):
    two backward-stable float64 least-squares solvers agree to about
    kappa^2 eps (1e-13), so 1e-10 leaves room."""
    drv, values, rho = _irls(nx)
    for v in range(2):
        x, A, b, num = _solve(drv, v, rho)
        assert num.rank == A.shape[1]
        ref = _lstsq(A, b)
        assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (nearest)."""
    u = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + (1 << 12)) >> 13) << 13
    return u.astype(np.uint32).view(np.float32)


def test_float32_path_within_bound_tf32_rounding_breaks():
    """The float32 path within 2e-5 of float64 lstsq (about kappa eps32 =
    4e-6, twice over, for the factor and the R solve); rounding A's values
    to TF32 (2^-11 relative) moves the answer by ~kappa 2^-11, past it."""
    bound = 2e-5
    drv, values, rho = _irls(6)
    x, A, b, _ = _solve(drv, 0, rho, dtype=np.float32)
    ref = _lstsq(A, b)
    assert np.abs(x - ref).max() <= bound * np.abs(ref).max()
    Am = drv.matrices[0]
    At = SparseCSC(Am.indptr, Am.indices,
                   _tf32(Am.data).astype(np.float64), Am.shape)
    num = spqr.qr_factorize(At, drv.S, b=b, dtype=np.float32, device="cpu")
    xt = np.empty(A.shape[1])
    xt[drv.S.sym.perm] = spqr.qr_rsolve(num, num.qtb[:, 0])
    assert np.abs(xt - ref).max() > bound * np.abs(ref).max()


@pytest.mark.parametrize("keep_q", [False, True])
def test_float32_factor_is_the_float64_fronts_rounded_once(keep_q):
    """A float32 R comes from fronts factored in float64 (front_dtype):
    it is the float64 factorization of the float32 values and b, with R
    rounded to float32 once, bit for bit; Q'b stays float64."""
    drv, values, rho = _irls(6)
    Am = drv.matrices[0]
    b = drv.rhs_of(_Pools(rho), 0, 0)
    S = spqr.qr_symbolic(Am)
    A32 = SparseCSC(Am.indptr, Am.indices,
                    Am.data.astype(np.float32).astype(np.float64), Am.shape)
    b32 = b.astype(np.float32).astype(np.float64)
    num32 = spqr.qr_factorize(Am, S, b=None if keep_q else b,
                              dtype=np.float32, keep_q=keep_q, device="cpu")
    num64 = spqr.qr_factorize(A32, S, b=None if keep_q else b32,
                              dtype=np.float64, keep_q=keep_q, device="cpu")
    assert spqr.front_dtype(torch.float32) == torch.float64
    assert num32.Rbuf.dtype == torch.float32
    assert torch.equal(num32.Rbuf, num64.Rbuf.to(torch.float32))
    assert np.array_equal(num32.qtb, num64.qtb)
    if keep_q:
        for q32, q64 in zip((q for lv in num32.Qs for q in lv),
                            (q for lv in num64.Qs for q in lv)):
            assert q32.dtype == np.float32
            assert np.array_equal(q32, q64.astype(np.float32))


def test_r_is_the_cholesky_factor_of_the_normal_matrix_up_to_signs():
    drv, values, rho = _irls(5)
    x, A, b, num = _solve(drv, 1, rho)
    p = drv.S.sym.perm
    Ap = torch.as_tensor(A[:, p])
    C = torch.linalg.cholesky(Ap.T @ Ap).numpy().T       # upper
    R = spqr.qr_get_r(num).toarray()
    assert np.allclose(np.triu(R), R, atol=0)
    assert np.abs(np.abs(R) - np.abs(C)).max() <= 1e-12 * np.abs(C).max()


def test_new_weights_through_the_value_map_equal_a_fresh_factor():
    drv, values, rho = _irls(6)
    S = spqr.qr_symbolic(drv.matrices[0])
    b = drv.rhs_of(_Pools(rho), 1, 0)
    spqr.qr_factorize(drv.matrices[0], S, b=b, device="cpu")
    vm = S.plan._cache["qr_value_map"]
    again = spqr.qr_factorize(drv.matrices[1], S, b=b, device="cpu")
    assert S.plan._cache["qr_value_map"] is vm
    fresh = spqr.qr_factorize(drv.matrices[1],
                              spqr.qr_symbolic(drv.matrices[1]), b=b,
                              device="cpu")
    assert torch.equal(again.Rbuf, fresh.Rbuf)
    assert np.array_equal(again.qtb, fresh.qtb)
    assert again.tol == fresh.tol


# ---------------------------------------------------------------------------
# qr_symbolic's maps against the per-entry loops (the reference's code)
# ---------------------------------------------------------------------------

def _loop_symbolic(A: SparseCSC, S) -> tuple:
    """arow_of_front, c_off, cb_off and every bucket's arrays, by the
    reference's loops over rows and entries, on S's ordering and
    supernodes."""
    m, n = A.shape
    ss = S.ss
    Ap = SparseCSC.from_scipy(A.to_scipy().tocsc()[:, S.sym.perm].tocsc())
    ApT = Ap.to_scipy().tocsr()
    leftmost = np.full(m, -1, dtype=INDEX)
    for i in range(m):
        lo, hi = ApT.indptr[i], ApT.indptr[i + 1]
        if hi > lo:
            leftmost[i] = ApT.indices[lo:hi].min()
    rows_list = [ss.rows_of(s) for s in range(ss.nsuper)]
    arow = []
    for s in range(ss.nsuper):
        j1, j2 = int(ss.super[s]), int(ss.super[s + 1])
        arow.append(np.where((leftmost >= j1) & (leftmost < j2))[0]
                    .astype(INDEX))
    nsuper = ss.nsuper
    crows = np.zeros(nsuper, dtype=INDEX)
    frows = np.zeros(nsuper, dtype=INDEX)
    children = [[] for _ in range(nsuper)]
    for s in range(nsuper):
        if int(ss.sn_parent[s]) != -1:
            children[int(ss.sn_parent[s])].append(s)
    for s in range(nsuper):
        ms, ns = ss.panel_shape(s)
        fr = len(arow[s]) + sum(int(crows[c]) for c in children[s])
        frows[s] = fr
        crows[s] = max(0, min(fr - ns, ms - ns)) if ms - ns > 0 else 0
    c_off = np.zeros(nsuper + 1, dtype=INDEX)
    np.cumsum([int(crows[s]) * (ss.panel_shape(s)[0] - ss.panel_shape(s)[1])
               for s in range(nsuper)], out=c_off[1:])
    cb_off = np.zeros(nsuper + 1, dtype=INDEX)
    np.cumsum(crows, out=cb_off[1:])
    levels = []
    for lv in S.levels:
        out = []
        for bq in lv:
            FR, FC, Np, B = bq.FR, bq.FC, bq.Np, len(bq.sids)
            a_src, a_dst, c_src, c_dst, cb_src, cb_dst = ([] for _ in
                                                          range(6))
            b_rows = np.full((B, FR), -1, dtype=INDEX)
            r_dst = np.full((B, FC, Np), ss.total, dtype=INDEX)
            c_out_dst = np.full((B, FR, FC), int(c_off[-1]), dtype=INDEX)
            cb_out_dst = np.full((B, FR), int(cb_off[-1]), dtype=INDEX)
            colidx = np.full((B, Np), n, dtype=INDEX)
            rowidx = np.full((B, FC), n, dtype=INDEX)
            for b, s in enumerate(bq.sids.tolist()):
                ms, ns = ss.panel_shape(s)
                rows_s = rows_list[s]
                colidx[b, :ns] = int(ss.super[s]) + np.arange(ns)
                rowidx[b, :ms - ns] = rows_s[ns:]
                colpos = {int(c): k for k, c in enumerate(rows_s)}
                base = b * FR * FC
                for rofs, r in enumerate(arow[s]):
                    b_rows[b, rofs] = r
                    for t in range(ApT.indptr[r], ApT.indptr[r + 1]):
                        a_src.append(t)
                        a_dst.append(base + rofs * FC
                                     + colpos[int(ApT.indices[t])])
                crofs = len(arow[s])
                for c in children[s]:
                    cc = ss.panel_shape(c)[0] - ss.panel_shape(c)[1]
                    cmap = np.array([colpos[int(x)] for x in
                                     rows_list[c][ss.panel_shape(c)[1]:]],
                                    dtype=INDEX)
                    for rr in range(int(crows[c])):
                        src = int(c_off[c]) + rr * cc
                        c_src.extend(range(src, src + cc))
                        c_dst.extend((base + (crofs + rr) * FC
                                      + cmap).tolist())
                        cb_src.append(int(cb_off[c]) + rr)
                        cb_dst.append(b * FR + crofs + rr)
                    crofs += int(crows[c])
                o, NpS = int(ss.panel_off[s]), int(ss.panel_Np[s])
                for t in range(min(int(frows[s]), ms, ns)):
                    for k in range(t, ms):
                        nk = k if k < ns else NpS + (k - ns)
                        r_dst[b, k, t] = o + nk * NpS + t
                for rr in range(int(crows[s])):
                    for k in range(ms - ns):
                        c_out_dst[b, ns + rr, ns + k] = (
                            int(c_off[s]) + rr * (ms - ns) + k)
                    cb_out_dst[b, ns + rr] = int(cb_off[s]) + rr
            ix = lambda a: np.array(a, dtype=INDEX)  # noqa: E731
            out.append(dict(
                a_src=ix(a_src), a_dst=ix(a_dst), c_src=ix(c_src),
                c_dst=ix(c_dst), b_rows=b_rows, c_brow_src=ix(cb_src),
                c_brow_dst=ix(cb_dst), r_dst=r_dst, c_out_dst=c_out_dst,
                cb_out_dst=cb_out_dst, colidx=colidx, rowidx=rowidx,
                ns=ix([ss.panel_shape(s)[1] for s in bq.sids]),
                fr=ix([frows[s] for s in bq.sids])))
        levels.append(out)
    return arow, c_off, cb_off, levels


def _rank_deficient():
    """grad3d(4) with a duplicated column: rank n - 2."""
    G = grad3d(4).tocsc()
    return SparseCSC.from_scipy(sp.hstack([G, G[:, [5]]]).tocsc())


def _wide():
    rng = np.random.default_rng(4)
    S = sp.random(40, 70, density=0.1, random_state=rng, format="csc")
    S = S + sp.csc_matrix((np.ones(40), (np.arange(40),
                                         rng.integers(0, 70, 40))),
                          shape=(40, 70))
    return SparseCSC.from_scipy(S.tocsc())


@pytest.mark.parametrize("name,make", [
    ("grad3d_tik_5", lambda: grad3d_tik(5)),
    ("unwrap3d_5", lambda: _irls(5)[0].matrices[0]),
    ("rank_deficient", _rank_deficient),
    ("wide", _wide),
])
def test_symbolic_maps_equal_the_loop_oracle(name, make):
    A = make()
    S = spqr.qr_symbolic(A, default_common())
    arow, c_off, cb_off, levels = _loop_symbolic(A, S)
    assert len(arow) == len(S.arow_of_front)
    for a, b in zip(arow, S.arow_of_front):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(c_off, S.c_off) and np.array_equal(cb_off, S.cb_off)
    assert (S.total_C, S.total_CB) == (int(c_off[-1]), int(cb_off[-1]))
    assert [len(lv) for lv in levels] == [len(lv) for lv in S.levels]
    for lo, lv in zip(levels, S.levels):
        for want, bq in zip(lo, lv):
            for key, a in want.items():
                b = getattr(bq, key)
                assert a.shape == b.shape and a.dtype == b.dtype, key
                assert np.array_equal(a, b), (name, key)


def test_spans_and_counters_are_recorded():
    trace.reset()
    drv, values, rho = _irls(5, dtype="float32")
    drv.analyze()
    assert drv.S.plan is not None

    class Pools:
        rhs = rho
        mix = {}

        @staticmethod
        def step(i):
            return (i + 1) % 2, i % 2

    for i in (-1, 0, 1):
        v, r, x = drv.step_refactor_solve(Pools, i)
        assert x.dtype == np.float64 and np.isfinite(x).all()
    got = trace.snapshot()
    for name in ("qr.symbolic", "plan.qr_rows", "plan.qr_maps",
                 "plan.qr_value_map", "plan.qr_device_maps", "qr.numeric",
                 "qr.numeric.values", "qr.numeric.upload",
                 "qr.numeric.gather", "qr.numeric.program",
                 "qr.numeric.check", "qr.numeric.download", "qr.solve",
                 "qr.solve.bind", "qr.solve.upload", "qr.solve.program",
                 "qr.solve.download", "program.qr.eager"):
        assert got.get(name, {}).get("count", 0) >= 1, name
    assert got["qr.numeric"]["count"] == got["qr.solve"]["count"] == 3
    assert got["plan.qr_value_map"]["count"] == 1
    assert got["qr.symbolic"]["calls"][-1].parent == ""
    assert got["qr.numeric.upload"]["h2d"] > 0
    assert got["qr.solve.download"]["d2h"] > 0
    c = drv.counters()
    assert c["program"] == "spqr" and c["itemsize"] == 4
    f = c["qr_fronts"]
    assert len(f["rows"]) == len(f["cols"]) == len(f["pivots"]) \
        == drv.S.ss.nsuper
    assert np.all(f["pivots"] <= f["cols"])
