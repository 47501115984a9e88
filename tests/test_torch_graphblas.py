"""The port's GraphBLAS layer (suitesparse_tpu_torch/graphblas) against the
JAX reference on the same seeded inputs, on the CPU.

float64 results agree to 1e-12 relative (the same terms, reduced in
another order by another backend); integers and bools exactly, in the
reference's dtype.  Host-only operations (build, extract, concat, ...)
agree exactly.  The algorithms run at n = 2,000; PageRank also stops at
the reference's iteration.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
import suitesparse_tpu.graphblas as rg
from suitesparse_tpu.graphblas import algorithms as ref_alg
from suitesparse_tpu.graphblas import core as ref_core

from chip_smoke import one_sync_pagerank
from suitesparse_tpu_torch.core.sparse import SparseCSC
import suitesparse_tpu_torch.graphblas as pg
from suitesparse_tpu_torch.graphblas import algorithms as port_alg
from suitesparse_tpu_torch.graphblas import core as port_core

CPU = "cpu"


def _pair(S):
    S = sp.csc_matrix(S)
    return RefCSC.from_scipy(S), SparseCSC.from_scipy(S)


def _rand(m, n, d=0.15, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=d, random_state=rng, format="csc")
    if lo is not None:
        S.data[:] = rng.uniform(lo, hi, S.nnz)
    return S


def _empty_rows(S, rows):
    """S with the given rows emptied (no stored entries)."""
    S = S.tolil()
    S[rows, :] = 0
    S = S.tocsc()
    S.eliminate_zeros()
    return S


def _ints(m, n, d, seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, d, random_state=rng, format="csc",
                  data_rvs=lambda k: rng.integers(1, 9, k).astype(float))
    return sp.csc_matrix(S.toarray().astype(dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(got, want, rtol=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        assert np.array_equal(got, want)
        return
    inf = np.isinf(want)
    assert np.array_equal(np.isinf(got), inf)
    assert np.array_equal(got[inf], want[inf])
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    g, w = got[~inf & ~nan], want[~inf & ~nan]
    if w.size:
        assert np.abs(g - w).max() <= rtol * max(np.abs(w).max(), 1e-300)


def _same_csc(got, want, rtol=1e-12):
    assert got.shape == want.shape
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    if want.data is None:
        assert got.data is None
    else:
        _close(got.data, want.data, rtol)


def _same_storage(got, want):
    assert (got.fmt, got.orientation, got.shape) == (want.fmt,
                                                     want.orientation,
                                                     want.shape)
    for f in ("indptr", "indices", "nonempty", "mask"):
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None
        else:
            assert np.array_equal(getattr(got, f), w), f
    for f in ("data", "dense"):
        if getattr(want, f) is not None:
            _close(getattr(got, f), getattr(want, f))
    assert (got.iso, got.iso_value) == (want.iso, want.iso_value)


# -- mxv / vxm with descriptors, masks, accum, y0 -------------------------

MXV_CASES = {
    "plain": dict(),
    "min_plus": dict(ring="min_plus"),
    "max_times": dict(ring="max_times"),
    "times_plus": dict(ring="times_plus"),
    "any_second": dict(ring="any_second"),
    "lor_land": dict(ring="lor_land"),
    "transpose": dict(desc="T0"),
    "mask": dict(mask=True),
    "mask_complement": dict(mask=True, desc="C"),
    "mask_structure": dict(mask="values", desc="S"),
    "mask_replace_y0": dict(mask=True, y0=True, desc="R"),
    "mask_y0": dict(mask=True, y0=True),
    "accum_y0": dict(accum="plus", y0=True),
    "accum_mask_y0": dict(accum="max", y0=True, mask=True, ring="min_plus"),
    "transpose_mask": dict(desc="T0", mask=True),
}


def _mxv_args(case, mod, n=18):
    c = MXV_CASES[case]
    rng = np.random.default_rng(7)
    kw = {}
    if "ring" in c:
        kw["ring"] = c["ring"]
    if c.get("mask") is True:
        kw["mask"] = rng.random(n) < 0.5
    elif c.get("mask") == "values":
        kw["mask"] = rng.integers(0, 3, n).astype(np.float64)
    if c.get("y0"):
        kw["y0"] = rng.standard_normal(n)
    if "accum" in c:
        kw["accum"] = c["accum"]
    d = c.get("desc")
    if d:
        kw["desc"] = getattr(mod, {"T0": "DESC_T0", "C": "DESC_C",
                                   "S": "DESC_S", "R": "DESC_R"}[d])
    return kw


@pytest.mark.parametrize("case", sorted(MXV_CASES))
def test_mxv_matches_reference(case):
    S = _empty_rows(_rand(18, 18, 0.2, 3), [5])
    ra, pa = _pair(S)
    x = np.random.default_rng(4).uniform(-1, 2, 18)
    want = rg.mxv(ra, x, **_mxv_args(case, rg))
    got = pg.mxv(pa, x, device=CPU, **_mxv_args(case, pg))
    assert isinstance(got, torch.Tensor)
    _close(got, want)


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "lor_land"])
def test_vxm_and_grbmatrix_input(ring):
    S = _rand(15, 12, 0.25, 5)
    ra, pa = _pair(S)
    x = np.random.default_rng(6).uniform(0.5, 1.5, 15)
    _close(pg.vxm(x, pa, ring, device=CPU), rg.vxm(x, ra, ring))
    G = pg.GrBMatrix.from_csc(pa, device=CPU)
    assert G.rows.dtype == torch.int64
    _close(pg.vxm(x, G, ring), rg.vxm(x, rg.GrBMatrix.from_csc(ra), ring))
    y = np.random.default_rng(7).uniform(0.5, 1.5, 12)
    _close(pg.mxv(G, y, ring), rg.mxv(ra, y, ring))


def test_mxv_grb_vector_and_int_values():
    S = _ints(14, 14, 0.3, 8)
    ra, pa = _pair(S)
    v = np.arange(14, dtype=np.int32) % 4
    for ring in ("plus_times", "min_plus", "max_first", "bor_band"):
        _close(pg.mxv(pa, v, ring, device=CPU), rg.mxv(ra, v, ring))
    # an integer result under a mask lifts to float, as JAX's weak 0.0
    m = np.arange(14) % 2 == 0
    _close(pg.mxv(pa, v, mask=m, device=CPU), rg.mxv(ra, v, mask=m))
    xv = np.random.default_rng(9).standard_normal(14)
    _close(pg.mxv(pa, pg.GrBVector.from_dense(xv), device=CPU),
           rg.mxv(ra, rg.GrBVector.from_dense(xv)))


@pytest.mark.parametrize("fmt", ["bitmap", "full"])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
def test_mxv_dense_storage(fmt, ring):
    S = _rand(20, 20, 0.4, 10)
    ra, pa = _pair(S)
    x = np.random.default_rng(11).standard_normal(20)
    _close(pg.mxv(pg.realize(pa, fmt), x, ring, device=CPU),
           rg.mxv(rg.realize(ra, fmt), x, ring))


# -- mxm ---------------------------------------------------------------------

MXM_CASES = {
    "plus_times": dict(),
    "min_plus": dict(ring="min_plus"),
    "T0": dict(desc="T0"),
    "T1": dict(desc="T1"),
    "T0T1": dict(desc="T0T1"),
    "accum": dict(accum="plus", C0=True),
    "accum_max": dict(accum="max", C0=True, ring="max_plus"),
    "mask": dict(mask=True),
    "mask_complement": dict(mask=True, desc="C"),
}


@pytest.mark.parametrize("case", sorted(MXM_CASES))
def test_mxm_matches_reference(case):
    c = MXM_CASES[case]
    (ra, pa), (rb, pb) = _pair(_rand(12, 12, 0.3, 51)), \
        _pair(_rand(12, 12, 0.3, 52))
    rm, pm = _pair(_rand(12, 12, 0.4, 53))

    def kw(mod, A, M):
        k = {}
        if "ring" in c:
            k["ring"] = c["ring"]
        if c.get("desc"):
            k["desc"] = getattr(mod, "DESC_" + c["desc"])
        if c.get("accum"):
            k["accum"], k["C0"] = c["accum"], A
        if c.get("mask"):
            k["mask"] = M
        return k
    want = rg.mxm(ra, rb, **kw(rg, ra, rm))
    got = pg.mxm(pa, pb, device=CPU, **kw(pg, pa, pm))
    _same_csc(got, want)


def test_mxm_empty_product():
    (ra, pa), (rb, pb) = _pair(sp.csc_matrix((5, 4))), _pair(_rand(4, 3))
    _same_csc(pg.mxm(pa, pb, device=CPU), rg.mxm(ra, rb))


@pytest.mark.parametrize("fa,fb", [("bitmap", "full"), ("bitmap", "bitmap"),
                                   ("full", "full")])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
def test_dense_mxm_matches_reference(fa, fb, ring):
    (ra, pa), (rb, pb) = _pair(_rand(70, 20, 0.5, 12)), \
        _pair(_rand(20, 25, 0.5, 13))
    want = rg.mxm(rg.realize(ra, fa), rg.realize(rb, fb), ring)
    got = pg.mxm(pg.realize(pa, fa), pg.realize(pb, fb), ring, device=CPU)
    _same_storage(got, want)


@pytest.mark.parametrize("complement", [False, True])
def test_dense_mxm_with_mask(complement):
    (ra, pa), (rb, pb) = _pair(_rand(10, 8, 0.6, 14)), \
        _pair(_rand(8, 9, 0.6, 15))
    rm, pm = _pair(_rand(10, 9, 0.3, 16))
    want = rg.mxm(rg.realize(ra, "bitmap"), rg.realize(rb, "bitmap"),
                  mask=rm, desc=rg.Descriptor(mask_complement=complement))
    got = pg.mxm(pg.realize(pa, "bitmap"), pg.realize(pb, "bitmap"),
                 mask=pm, desc=pg.Descriptor(mask_complement=complement),
                 device=CPU)
    _same_storage(got, want)


# -- eWise / apply / select / reduce / kron / build ---------------------

EWISE_CASES = [("add", "plus"), ("add", "max"), ("add", "minus"),
               ("mult", "times"), ("mult", "min"), ("mult", "div"),
               ("union", "minus"), ("union", "plus")]


@pytest.mark.parametrize("kind,op", EWISE_CASES)
@pytest.mark.parametrize("masked", [None, "mask", "complement"])
def test_ewise_matches_reference(kind, op, masked):
    (ra, pa), (rb, pb) = _pair(_rand(12, 12, 0.3, 55)), \
        _pair(_rand(12, 12, 0.3, 56))
    rm, pm = _pair(sp.triu(np.ones((12, 12))).tocsc())

    def call(mod, A, B, M, **kw):
        if masked:
            kw["mask"] = M
            kw["desc"] = mod.Descriptor(mask_complement=masked == "complement")
        if kind == "union":
            return mod.ewise_union(A, B, op, alpha=5.0, beta=3.0, **kw)
        fn = mod.ewise_add if kind == "add" else mod.ewise_mult
        return fn(A, B, op, **kw)
    want = call(rg, ra, rb, rm)
    got = call(pg, pa, pb, pm, device=CPU)
    _same_csc(got, want)


@pytest.mark.parametrize("kind,op", [("add", "plus"), ("mult", "plus"),
                                     ("add", "max"), ("mult", "times")])
def test_dense_ewise_matches_reference(kind, op):
    (ra, pa), (rb, pb) = _pair(_rand(22, 19, 0.4, 14)), \
        _pair(_rand(22, 19, 0.4, 15))
    rm, pm = _pair(_rand(22, 19, 0.5, 17))
    fr = rg.ewise_add if kind == "add" else rg.ewise_mult
    fp = pg.ewise_add if kind == "add" else pg.ewise_mult
    for mask_r, mask_p in ((None, None), (rm, pm)):
        want = fr(rg.realize(ra, "bitmap"), rg.realize(rb, "full"), op,
                  mask=mask_r)
        got = fp(pg.realize(pa, "bitmap"), pg.realize(pb, "full"), op,
                 mask=mask_p, device=CPU)
        _same_storage(got, want)


@pytest.mark.parametrize("op", ["identity", "ainv", "minv", "abs", "lnot",
                                "one", "sqrt", "exp", "log"])
def test_apply_matches_reference(op):
    ra, pa = _pair(_rand(14, 14, 0.3, 20, lo=0.5, hi=3.0))
    _same_csc(pg.apply(pa, op, device=CPU), rg.apply(ra, op))


@pytest.mark.parametrize("op", ["ainv", "minv", "abs", "lnot", "bnot",
                                "one", "sqrt"])
def test_apply_int_values(op):
    ra, pa = _pair(_ints(10, 10, 0.4, 21))
    _same_csc(pg.apply(pa, op, device=CPU), rg.apply(ra, op))


@pytest.mark.parametrize("pred,thunk", [("tril", 0.0), ("tril", -1),
                                        ("triu", 0.0), ("diag", 0.0),
                                        ("offdiag", 0.0), ("nonzero", 0.0),
                                        ("gt", 0.5), ("ge", 0.5),
                                        ("lt", 0.5), ("le", 0.5),
                                        ("eq", 0.0), ("ne", 0.0),
                                        ("lambda", 0.0)])
def test_select_matches_reference(pred, thunk):
    S = _rand(15, 15, 0.4, 22) + sp.eye(15) * 0.25
    ra, pa = _pair(S)
    p = (lambda r, c, v: (r + c) % 3 == 0) if pred == "lambda" else pred
    _same_csc(pg.select(pa, p, thunk), rg.select(ra, p, thunk))


@pytest.mark.parametrize("monoid", ["plus", "times", "min", "max", "any",
                                    "lor", "land", "lxor"])
def test_reduce_matches_reference(monoid):
    S = _empty_rows(_rand(14, 14, 0.2, 23, lo=-1.0, hi=2.0), [4])
    ra, pa = _pair(S)
    _close(pg.reduce_rows(pa, monoid, device=CPU), rg.reduce_rows(ra, monoid))
    _close(pg.reduce_scalar(pa, monoid, device=CPU),
           rg.reduce_scalar(ra, monoid))


@pytest.mark.parametrize("monoid", ["plus", "min", "max", "band", "bor",
                                    "lxor"])
def test_reduce_int_values(monoid):
    """Integer reductions, including the folded bitwise monoids."""
    S = _empty_rows(_ints(16, 16, 0.3, 24), [3])
    ra, pa = _pair(S)
    _close(pg.reduce_rows(pa, monoid, device=CPU), rg.reduce_rows(ra, monoid))
    _close(pg.reduce_scalar(pa, monoid, device=CPU),
           rg.reduce_scalar(ra, monoid))


def test_reduce_empty_matrix():
    ra, pa = _pair(sp.csc_matrix((4, 4)))
    for monoid in ("plus", "min"):
        _close(pg.reduce_scalar(pa, monoid, device=CPU),
               rg.reduce_scalar(ra, monoid))


@pytest.mark.parametrize("op", ["times", "plus", "min", "first"])
def test_kron_transpose_matches_reference(op):
    (ra, pa), (rb, pb) = _pair(_rand(4, 3, 0.5, 11)), \
        _pair(_rand(3, 2, 0.6, 12))
    _same_csc(pg.kron(pa, pb, op, device=CPU), rg.kron(ra, rb, op))
    _same_csc(pg.transpose(pa), rg.transpose(ra))


@pytest.mark.parametrize("dup", ["plus", "times", "min", "max", "first",
                                 "second", "any"])
def test_build_dup_ops(dup):
    rng = np.random.default_rng(25)
    r = rng.integers(0, 6, 40)
    c = rng.integers(0, 5, 40)
    v = rng.standard_normal(40)
    _same_csc(pg.build(r, c, v, (6, 5), dup=dup),
              rg.build(r, c, v, (6, 5), dup=dup))


def test_extract_assign_tuples():
    (ra, pa), (rb, pb) = _pair(_rand(10, 9, 0.3, 26)), \
        _pair(_rand(3, 2, 0.8, 27))
    rows, cols = np.array([7, 1, 4]), np.array([0, 8, 3, 5])
    _same_csc(pg.extract(pa, rows, cols), rg.extract(ra, rows, cols))
    _same_csc(pg.assign(pa, rows, [2, 6], pb), rg.assign(ra, rows, [2, 6], rb))
    for g, w in zip(pg.extract_tuples(pa), rg.extract_tuples(ra)):
        assert np.array_equal(g, w)


def test_concat_split_reshape_sort():
    ra, pa = _pair(_rand(9, 7, 0.3, 2))
    tr, tp = rg.split(ra, [4, 5], [3, 4]), pg.split(pa, [4, 5], [3, 4])
    for row_r, row_p in zip(tr, tp):
        for a, b in zip(row_r, row_p):
            _same_csc(b, a)
    _same_csc(pg.concat(tp), rg.concat(tr))
    for by_col in (True, False):
        _same_csc(pg.reshape(pa, 21, 3, by_col), rg.reshape(ra, 21, 3, by_col))
    for op in ("lt", "gt"):
        for by_col in (True, False):
            (c1, p1), (c2, p2) = (pg.sort(pa, op, by_col),
                                  rg.sort(ra, op, by_col))
            _same_csc(c1, c2)
            _same_csc(p1, p2)


# -- typed ops, user registration ----------------------------------------

def test_integer_and_bool_semirings_keep_dtype():
    S = _ints(20, 20, 0.2, 3)
    ra, pa = _pair(S)
    _same_csc(pg.mxm(pa, pa, device=CPU), rg.mxm(ra, ra))
    Sb = sp.csc_matrix(S.toarray() != 0)
    rb, pb = _pair(Sb)
    for ring in ("lor_land", "land_lor", "lxor_land", "any_pair"):
        _same_csc(pg.mxm(pb, pb, ring, device=CPU), rg.mxm(rb, rb, ring))


def test_logical_binops_on_negatives():
    a = np.array([-1.0, 0.0, 2.0])
    b = np.array([0.0, 0.0, -3.0])
    for op in ("lor", "land", "lxor", "eq", "ne", "gt", "lt", "ge", "le",
               "div", "rdiv", "minus", "rminus", "min", "max"):
        got = port_core.BINOPS[op](torch.from_numpy(a), torch.from_numpy(b))
        want = ref_core.BINOPS[op](jnp.asarray(a), jnp.asarray(b))
        _close(got, want)
    ai, bi = np.array([7, -3, 4], np.int32), np.array([2, 5, -8], np.int32)
    for op in ("div", "band", "bor", "bxor", "plus", "minus", "times"):
        got = port_core.BINOPS[op](torch.from_numpy(ai), torch.from_numpy(bi))
        want = ref_core.BINOPS[op](jnp.asarray(ai), jnp.asarray(bi))
        _close(got, want)


@pytest.mark.parametrize("name", ["plus", "times", "min", "max", "any",
                                  "lor", "land", "lxor", "band", "bor"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.uint8, np.int64,
                                   np.float32, np.float64, np.bool_])
def test_typed_identities(name, dtype):
    want = ref_core.MONOIDS[name]
    got = port_core.MONOIDS[name]
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    try:
        w = want.identity_for(dtype)
    except (OverflowError, ValueError) as err:   # e.g. band over uint8
        for dt in (dtype, tdt):
            with pytest.raises(type(err)):
                got.identity_for(dt)
        return
    for dt in (dtype, tdt):
        g = got.identity_for(dt)
        assert type(g) is type(w) and (g == w or (g != g and w != w))


def test_user_registered_semiring_and_monoid():
    ref_core.register_binop("absdiff", lambda a, b: jnp.abs(a - b))
    ref_core.register_semiring("max_absdiff", "max", "absdiff")
    port_core.register_binop("absdiff", lambda a, b: torch.abs(a - b))
    port_core.register_semiring("max_absdiff", "max", "absdiff")
    S = _ints(20, 20, 0.12, 5).astype(np.float64)
    ra, pa = _pair(S)
    _same_csc(pg.mxm(pa, pa, "max_absdiff", device=CPU),
              rg.mxm(ra, ra, "max_absdiff"))
    # a user monoid with no native reduction: the segment fold
    ref_core.register_monoid("bxorm", jnp.bitwise_xor, 0)
    port_core.register_monoid("bxorm", torch.bitwise_xor, 0)
    Si = _ints(15, 15, 0.3, 6)
    ri, pi = _pair(Si)
    _same_csc(pg.mxm(pi, pi, "bxorm_times", device=CPU),
              rg.mxm(ri, ri, "bxorm_times"))
    _close(pg.reduce_rows(pi, "bxorm", device=CPU),
           rg.reduce_rows(ri, "bxorm"))
    # a non-commutative float fold keeps the reference's left-to-right order
    ref_core.register_monoid("lastwins", lambda a, b: 0.5 * a + b, 0.0)
    port_core.register_monoid("lastwins", lambda a, b: 0.5 * a + b, 0.0)
    rf, pf = _pair(_rand(12, 12, 0.4, 7, lo=0.5, hi=1.5))
    _close(pg.reduce_rows(pf, "lastwins", device=CPU),
           rg.reduce_rows(rf, "lastwins"))


def test_bitwise_semiring_and_sparse_complement_mask():
    Si = _ints(16, 16, 0.3, 7)
    ri, pi = _pair(Si)
    _same_csc(pg.mxm(pi, pi, "bor_band", device=CPU), rg.mxm(ri, ri, "bor_band"))
    (ra, pa), (rm, pm) = _pair(_ints(50, 50, 0.12, 9, np.float64)), \
        _pair(_ints(50, 50, 0.12, 11, np.float64))
    _same_csc(pg.ewise_mult(pa, pa, "times", mask=pm, desc=pg.DESC_C,
                            device=CPU),
              rg.ewise_mult(ra, ra, "times", mask=rm, desc=rg.DESC_C))


# -- objects -------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["hypersparse", "sparse", "bitmap", "full"])
@pytest.mark.parametrize("orient", ["by_row", "by_col"])
def test_storage_formats_match_reference(fmt, orient):
    ra, pa = _pair(_rand(30, 25, 0.15, 40))
    want, got = rg.realize(ra, fmt, orient), pg.realize(pa, fmt, orient)
    _same_storage(got, want)
    _same_csc(pg.to_csc(got), rg.to_csc(want))


def test_auto_format_vectors_iterators():
    for S in (sp.csc_matrix(np.ones((10, 10))),
              sp.random(20, 20, density=0.5, format="csc", random_state=1),
              sp.csc_matrix((np.ones(3), ([0, 1, 2], [0, 0, 0])),
                            shape=(100, 100)),
              _rand(100, 100, 0.01, 2)):
        ra, pa = _pair(S)
        assert pg.auto_format(pa) == rg.auto_format(ra)
    v1 = pg.GrBVector.build(10, [3, 1, 3], [1.0, 2.0, 5.0], dup="max")
    v2 = rg.GrBVector.build(10, [3, 1, 3], [1.0, 2.0, 5.0], dup="max")
    assert np.array_equal(v1.to_dense(), v2.to_dense())
    ra, pa = _pair(_rand(12, 12, 0.3, 54))
    for kind in ("entry", "row", "col"):
        got = list(pg.MatrixIterator(pa, kind))
        want = list(rg.MatrixIterator(ra, kind))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert np.array_equal(a, b)


# -- positional, index-unary, pack/unpack --------------------------------

@pytest.mark.parametrize("op", ["firsti", "firsti1", "firstj", "firstj1",
                                "secondi", "secondi1", "secondj",
                                "secondj1"])
@pytest.mark.parametrize("monoid", ["min", "max", "any"])
def test_positional_mxm(op, monoid):
    (ra, pa), (rb, pb) = _pair(_rand(8, 7, 0.4, 0, 1, 2)), \
        _pair(_rand(7, 6, 0.4, 1, 1, 2))
    _same_csc(pg.positional_mxm(pa, pb, f"{monoid}_{op}", device=CPU),
              rg.positional_mxm(ra, rb, f"{monoid}_{op}"))


@pytest.mark.parametrize("ring", ["min_firsti", "max_firstj1", "any_firsti"])
def test_positional_mxv(ring):
    ra, pa = _pair(_rand(8, 8, 0.4, 2, 1, 2))
    x = np.random.default_rng(3).uniform(0, 1, 8)
    _close(pg.positional_mxv(pa, x, ring, device=CPU),
           rg.positional_mxv(ra, x, ring))


@pytest.mark.parametrize("op,thunk", [("rowindex", 1), ("colindex", 0),
                                      ("diagindex", 2), ("tril", -1),
                                      ("valuegt", 0.5)])
def test_index_unary_ops(op, thunk):
    ra, pa = _pair(_rand(8, 8, 0.6, 4))
    _same_csc(pg.apply_indexop(pa, op, thunk), rg.apply_indexop(ra, op, thunk))
    _same_csc(pg.select_indexop(pa, op, thunk),
              rg.select_indexop(ra, op, thunk))


def test_pack_unpack():
    S = _rand(6, 5, 0.5, 3)
    got = pg.pack_csc(6, 5, S.indptr, S.indices[::1], S.data, jumbled=True)
    want = rg.pack_csc(6, 5, S.indptr, S.indices[::1], S.data, jumbled=True)
    _same_csc(got, want)
    for g, w in zip(pg.unpack_csc(got), rg.unpack_csc(want)):
        assert np.array_equal(g, w)
    R = sp.random(4, 6, density=0.5, random_state=np.random.default_rng(4),
                  format="csr")
    _same_csc(pg.pack_csr(4, 6, R.indptr, R.indices, R.data),
              rg.pack_csr(4, 6, R.indptr, R.indices, R.data))
    coo = R.tocoo()
    _same_csc(pg.pack_coo(4, 6, coo.row, coo.col, coo.data, dup="max"),
              rg.pack_coo(4, 6, coo.row, coo.col, coo.data, dup="max"))
    D = np.arange(12, dtype=float).reshape(3, 4) + 1
    assert np.array_equal(pg.unpack_full(pg.pack_full(D)),
                          rg.unpack_full(rg.pack_full(D)))
    for g, w in zip(pg.unpack_bitmap(pg.pack_bitmap(D > 6, D)),
                    rg.unpack_bitmap(rg.pack_bitmap(D > 6, D))):
        assert np.array_equal(g, w)
    for g, w in zip(pg.unpack_csr(got), rg.unpack_csr(want)):
        assert np.array_equal(g, w)
    for g, w in zip(pg.unpack_coo(got), rg.unpack_coo(want)):
        assert np.array_equal(g, w)


# -- algorithms at n = 2,000 -----------------------------------------------

def _ring_graph(n=2000, seed=22):
    """test_spgemm.py's generator: ring + 3n random chords."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 3 * n)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, 3 * n)])
    keep = src != dst
    S = sp.csc_matrix((np.ones(keep.sum()), (src[keep], dst[keep])),
                      shape=(n, n))
    S.sum_duplicates()
    S.data[:] = 1.0
    return S


def _sym_graph(n=2000, seed=23):
    """test_spgemm.py's symmetrized random graph, 4n edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4 * n)
    dst = rng.integers(0, n, 4 * n)
    keep = src != dst
    S = sp.csc_matrix((np.ones(keep.sum()), (src[keep], dst[keep])),
                      shape=(n, n))
    return ((S + S.T) != 0).astype(float).tocsc()


@pytest.mark.parametrize("tol,max_iter", [(1e-9, 100), (1e-6, 100),
                                          (0.0, 7)])
def test_pagerank_matches_reference(tol, max_iter):
    """Same ranks (1e-12) and the same iteration: the reference stops at
    the port's count and not one step earlier."""
    ra, pa = _pair(_ring_graph())
    want = ref_alg.pagerank(ra, tol=tol, max_iter=max_iter)
    got = pg.pagerank(pa, tol=tol, max_iter=max_iter, device=CPU)
    _close(got, want)
    Ac = pa
    rows, cols, _ = port_alg._coo_arrays(Ac, torch.device(CPU))
    outdeg = torch.clamp(torch.bincount(rows, minlength=2000).double(),
                         min=1.0)
    _, iters = port_alg._pagerank_loop(rows, cols, 1.0 / outdeg[rows], 2000,
                                       0.85, tol, max_iter)
    assert 1 <= iters <= max_iter
    assert np.array_equal(ref_alg.pagerank(ra, tol=tol, max_iter=iters), want)
    if iters > 1:
        assert not np.array_equal(
            ref_alg.pagerank(ra, tol=tol, max_iter=iters - 1), want)


@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("tol,max_iter", [(1e-9, 100), (1e-6, 100),
                                          (0.0, 7), (1e-9, 0), (0.0, 9)])
def test_pagerank_steps_stop_at_the_reference_iteration(steps, tol,
                                                        max_iter):
    """Programs of 1, 3 and 8 predicated steps a run: the same iteration
    as the reference (a tolerance met inside a run, caps of 7 and 9 that
    are no multiple of 3 or 8, a cap of 0) and ranks bit-identical to the
    one-sync loop, within 1e-12 of the reference's."""
    ra, pa = _pair(_ring_graph())
    want = ref_alg.pagerank(ra, tol=tol, max_iter=max_iter)
    dev = torch.device(CPU)
    rows, cols, _ = port_alg._coo_arrays(pa, dev)
    outdeg = torch.clamp(torch.bincount(rows, minlength=2000).double(),
                         min=1.0)
    w = 1.0 / outdeg[rows]
    r1, it1 = one_sync_pagerank(rows, cols, w, 2000, tol, max_iter)
    cache = {}
    for _ in range(2):               # a second run reuses the program
        r, it = port_alg._pagerank_loop(rows, cols, w, 2000, 0.85, tol,
                                        max_iter, steps=steps, cache=cache)
        assert it == it1 and torch.equal(r, r1)
    assert len(cache) == 1
    _close(r.numpy(), want)
    if it:
        assert np.array_equal(ref_alg.pagerank(ra, tol=tol, max_iter=it),
                              want)
    if it < max_iter:
        assert tol > 0                  # stopped by the tolerance
    if it > 1:
        assert not np.array_equal(
            ref_alg.pagerank(ra, tol=tol, max_iter=it - 1), want)
    got, its = port_alg._pagerank(pa, 0.85, tol, max_iter, dev, steps)
    assert its == it and torch.equal(got, r1)


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_bfs_steps_stop_at_the_reference_iteration(steps):
    """BFS programs of 1, 3 and 8 predicated steps: the reference's levels
    and its number of pull steps (one past the deepest level, where the
    frontier empties), on the ring graph and on one with an unreachable
    half; the program is cached with the pattern."""
    P = sp.diags([np.ones(9)], [1], shape=(10, 10)).tocsc()
    for S, source in ((_ring_graph(), 0), (_ring_graph(), 777),
                      (sp.block_diag([P[:5, :5], P[:5, :5]]).tocsc(), 0)):
        ra, pa = _pair(S)
        want = np.asarray(ref_alg.bfs_levels(ra, source))
        rows, cols, _ = port_alg._coo_arrays(pa, torch.device(CPU))
        level, depth = port_alg._bfs_loop(rows, cols, S.shape[0], source,
                                          steps=steps)
        assert np.array_equal(level.numpy(), want)
        assert depth == int(want.max()) + 1
    for _ in range(2):
        assert np.array_equal(pg.bfs_levels(pa, 0, device=CPU), want)
    assert {key[0] for key in pa._loop_programs} == {"bfs_arrays", "bfs"}


@pytest.mark.parametrize("source", [0, 777])
def test_bfs_matches_reference(source):
    ra, pa = _pair(_ring_graph())
    want = ref_alg.bfs_levels(ra, source)
    for method in ("device", "push"):
        got = pg.bfs_levels(pa, source, method, device=CPU)
        _close(got, want)
    # an unreachable part keeps -1
    P = sp.diags([np.ones(9)], [1], shape=(10, 10)).tocsc()
    B = sp.block_diag([P[:5, :5], P[:5, :5]]).tocsc()
    rb, pb = _pair(B)
    _close(pg.bfs_levels(pb, 0, device=CPU), ref_alg.bfs_levels(rb, 0))


def test_triangle_count_matches_reference():
    ra, pa = _pair(_sym_graph())
    want = ref_alg.triangle_count(ra)
    got = pg.triangle_count(pa, device=CPU)
    assert type(got) is int and got == want
    L = sp.tril(_sym_graph(), -1).tocsc()
    assert got == int((L @ L.T).multiply(L).sum())
    K4 = sp.csc_matrix(np.ones((4, 4)) - np.eye(4))
    assert pg.triangle_count(SparseCSC.from_scipy(K4), device=CPU) == 4
