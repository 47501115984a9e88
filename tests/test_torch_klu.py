"""The port's KLU (lu/klu.py, host) and its device twin (lu/klu_device.py)
against the JAX reference on the CPU in float64.  The host functions run
the same native Gilbert-Peierls kernel and the same NumPy code, so their
results are identical; the device twin is held against the reference's
jitted twin (jax.vmap for the batched sweep): factors and solves within
1e-12, the same zero-pivot flag, Inf/NaN patterns included."""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import suitesparse_tpu.lu as ref_lu
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC

import suitesparse_tpu_torch.lu as port_lu
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.io import generators

TOL = 1e-12


def multiblock(seed=10):
    """Many BTF blocks (singleton runs and small irreducible blocks) in
    several solve levels (the reference's test_multiblock_levels matrix,
    plus 2x2 and 3x3 cycles)."""
    rng = np.random.default_rng(seed)
    n = 40
    S = sp.lil_matrix((n, n))
    for i in range(n):
        S[i, i] = 2.0 + rng.random()
    for _ in range(60):                  # strictly upper -> many blocks
        i = rng.integers(0, n - 1)
        S[i, rng.integers(i + 1, n)] = rng.standard_normal()
    for i in (5, 20):                    # small cycles: blocks of 2 and 3
        S[i, i + 1] = S[i + 1, i] = 0.5
    S[30, 31] = S[31, 32] = S[32, 30] = 0.5
    return PortCSC.from_scipy(S.tocsc())


def complex_matrix(n=60, seed=5):
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, density=0.06, random_state=rng, format="csc")
    S = sp.csc_matrix(S + 1j * sp.random(n, n, density=0.06,
                                         random_state=rng, format="csc")
                      + (5 + 2j) * sp.identity(n))
    return PortCSC.from_scipy(S)


CASES = {
    "circuit300": lambda: generators.circuit_like(300, seed=3),
    "unsym200": lambda: generators.random_unsym(200, 0.02, seed=4),
    "multiblock": multiblock,
    "complex": complex_matrix,
}


def _ref(A):
    return RefCSC(A.indptr, A.indices, A.data, A.shape)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port A, ref A, (ref sym, num), (port sym, num))"""
    Ap = CASES[name]()
    Ar = _ref(Ap)
    sr = ref_lu.klu_analyze(Ar)
    sp_ = port_lu.klu_analyze(Ap)
    return Ap, Ar, (sr, ref_lu.klu_factor(Ar, sr)), \
        (sp_, port_lu.klu_factor(Ap, sp_))


def _same_klu(nr, np_):
    for k in ("pnum", "Rs", "p_final"):
        assert np.array_equal(getattr(nr, k), getattr(np_, k)), k
    assert (nr.singular_col, nr.flops) == (np_.singular_col, np_.flops)
    assert (nr.offdiag != np_.offdiag).nnz == 0
    for br, bp in zip(nr.blocks, np_.blocks, strict=True):
        for k in ("Lp", "Li", "Lx", "Up", "Ui", "Ux", "pivot_rows"):
            assert np.array_equal(getattr(br, k), getattr(bp, k)), k


@pytest.mark.parametrize("name", list(CASES))
def test_host_klu_is_the_reference(name):
    Ap, Ar, (sr, nr), (sp_, np_) = _case(name)
    for k in ("p", "q", "r"):
        assert np.array_equal(getattr(sr, k), getattr(sp_, k)), k
    assert (sr.nblocks, sr.nmatch, sr.ordering) == \
        (sp_.nblocks, sp_.nmatch, sp_.ordering)
    _same_klu(nr, np_)
    rng = np.random.default_rng(3)
    A2r = RefCSC(Ar.indptr, Ar.indices,
                 Ar.data * (1 + 0.2 * rng.random(Ar.nnz)), Ar.shape)
    A2p = PortCSC(A2r.indptr, A2r.indices, A2r.data, A2r.shape)
    nr2 = ref_lu.klu_refactor(A2r, sr, ref_lu.klu_factor(Ar, sr))
    np2 = port_lu.klu_refactor(A2p, sp_, port_lu.klu_factor(Ap, sp_))
    _same_klu(nr2, np2)
    B = rng.standard_normal((Ap.ncol, 2))
    for tr in (False, True):
        assert np.array_equal(ref_lu.klu_solve(nr2, B, transpose=tr),
                              port_lu.klu_solve(np2, B, transpose=tr))
    assert ref_lu.klu_rcond(nr2) == port_lu.klu_rcond(np2)
    assert ref_lu.klu_rgrowth(A2r, nr2) == port_lu.klu_rgrowth(A2p, np2)
    if not np.iscomplexobj(Ap.data):
        assert ref_lu.klu_condest(A2r, nr2) == port_lu.klu_condest(A2p, np2)


def test_python_twin_is_the_reference():
    """The Gilbert-Peierls Python twin (the path without the native
    library) gives the reference twin's factor."""
    from suitesparse_tpu.lu.klu import _gp_lu_block_py as ref_gp
    from suitesparse_tpu_torch.lu.klu import _gp_lu_block_py as port_gp
    S = generators.random_unsym(80, 0.08, seed=6).to_scipy().tocsc()
    S = sp.csc_matrix(S + 3.0 * sp.identity(80))
    for halt in (False, True):
        r = ref_gp(S.indptr, S.indices, S.data, 80, 0.001, halt)
        p = port_gp(S.indptr, S.indices, S.data, 80, 0.001, halt)
        for k in ("Lp", "Li", "Lx", "Up", "Ui", "Ux", "pivot_rows"):
            assert np.array_equal(getattr(r[0], k), getattr(p[0], k)), k
        assert np.array_equal(r[1], p[1]) and r[2:] == p[2:]


def _device_pair(name, scale=None):
    Ap, Ar, (sr, nr), (sp_, np_) = _case(name)
    rc, pc = ref_common(), port_common()
    if scale is not None:
        rc.lu.scale = pc.lu.scale = scale
    return (Ap, Ar, ref_lu.klu_device(Ar, sr, nr, rc),
            port_lu.klu_device(Ap, sp_, np_, pc, device="cpu"))


def _same_factors(fr, fp):
    assert len(fr) == len(fp)
    for a, b in zip(fr, fp):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape
        assert np.array_equal(np.isnan(a), np.isnan(b))
        fin = np.isfinite(a)
        assert np.array_equal(fin, np.isfinite(b))
        assert np.array_equal(a[~fin & ~np.isnan(a)], b[~fin & ~np.isnan(b)])
        if fin.any():
            assert np.abs(a[fin] - b[fin]).max() <= TOL * max(
                1.0, np.abs(a[fin]).max())


@pytest.mark.parametrize("scale", [None, "max", "none"])
@pytest.mark.parametrize("name", list(CASES))
def test_device_twin_matches_reference(name, scale):
    Ap, Ar, (_, rref, rsol), (plan, pref, psol) = _device_pair(name, scale)
    assert plan.levels and len(plan.groups) >= 1
    rng = np.random.default_rng(7)
    av = Ap.data * (1.0 + 0.3 * rng.standard_normal(Ap.nnz))
    fr, Rr, okr = rref(jnp.asarray(av))
    fp, Rp, okp = pref(av)
    assert bool(okr) == bool(okp) and okp.shape == ()
    _same_factors(fr, fp)
    assert np.abs(np.asarray(Rr) - Rp.numpy()).max() <= TOL * np.abs(
        np.asarray(Rr)).max()
    n = Ap.ncol
    for b in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        if np.iscomplexobj(av):
            b = b + 1j * rng.standard_normal(b.shape)
        xr = np.asarray(rsol(fr, Rr, jnp.asarray(av), jnp.asarray(b)))
        xp = psol(fp, Rp, av, b).numpy()
        assert xp.shape == b.shape
        assert np.abs(xp - xr).max() <= TOL * np.abs(xr).max()
    if name == "multiblock":
        assert len(plan.levels) > 2 and len(plan.groups) > 2


def test_batched_sweep_matches_vmap():
    """S value sets in one call, the reference's jax.vmap: the same
    factors, flags and solutions for each set."""
    Ap, Ar, (_, rref, rsol), (_, pref, psol) = _device_pair("circuit300")
    rng = np.random.default_rng(8)
    sweeps = Ap.data[None, :] * (1.0 + 0.2 * rng.standard_normal((5, Ap.nnz)))
    b = rng.standard_normal(Ap.ncol)
    fr, Rr, okr = jax.vmap(rref)(jnp.asarray(sweeps))
    xr = jax.vmap(lambda f, r, a: rsol(f, r, a, jnp.asarray(b)))(
        fr, Rr, jnp.asarray(sweeps))
    fp, Rp, okp = pref(torch.as_tensor(sweeps))
    assert okp.shape == (5,) and okp.tolist() == np.asarray(okr).tolist()
    _same_factors(fr, fp)
    xp = psol(fp, Rp, torch.as_tensor(sweeps), b)
    assert xp.shape == (5, Ap.ncol)
    assert np.abs(xp.numpy() - np.asarray(xr)).max() <= TOL * np.abs(
        np.asarray(xr)).max()
    # per-set right-hand sides, several columns each
    B = rng.standard_normal((5, Ap.ncol, 2))
    X = psol(fp, Rp, torch.as_tensor(sweeps), B).numpy()
    for s in range(5):
        S = sp.csc_matrix((sweeps[s], Ap.indices, Ap.indptr), shape=Ap.shape)
        assert np.abs(S @ X[s] - B[s]).max() < 1e-10


@pytest.mark.parametrize("kind", ["zeros", "zero_pivot", "inf", "nan"])
def test_singular_and_nonfinite_flags_match_reference(kind):
    """A zero pivot is replaced by 1 and flagged; Inf and NaN spread
    through the rank-1 steps exactly as in the reference (0 * Inf)."""
    Ap, Ar, (sr, _), (_, rref, _), (_, pref, _) = \
        (*_case("circuit300")[:3], *_device_pair("circuit300")[2:])
    av = Ap.data.copy()
    j = int(sr.q[0])
    lo, hi = int(Ap.indptr[j]), int(Ap.indptr[j + 1])
    if kind == "zeros":
        av[:] = 0.0
    elif kind == "zero_pivot":
        av[lo:hi] = 0.0
    else:
        av[lo + (hi - lo) // 2] = np.inf if kind == "inf" else np.nan
    fr, _, okr = rref(jnp.asarray(av))
    fp, _, okp = pref(av)
    assert bool(okr) == bool(okp)
    if kind in ("zeros", "zero_pivot"):
        assert not bool(okp)
    _same_factors(fr, fp)


def test_device_twin_values_and_defaults():
    """Host values take the device's default dtype (float64 on the CPU);
    a tensor keeps its own; refactors are bit-identical."""
    Ap, _, _, (_, pref, psol) = _device_pair("circuit300")
    f64, R64, _ = pref(Ap.data)
    assert f64[0].dtype == torch.float64 and R64.dtype == torch.float64
    f32, R32, ok32 = pref(torch.as_tensor(Ap.data, dtype=torch.float32))
    assert f32[0].dtype == torch.float32 and bool(ok32)
    again = pref(Ap.data)
    assert all(torch.equal(a, b) for a, b in zip(f64, again[0]))
    b = np.ones(Ap.ncol)
    x = psol(f32, R32, torch.as_tensor(Ap.data, dtype=torch.float32), b)
    assert x.dtype == torch.float32
    r = Ap.to_scipy() @ x.double().numpy() - b
    assert np.abs(r).max() < 1e-5
