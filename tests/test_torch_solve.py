"""The port's solves against the JAX reference, f64 on the CPU.

The reference's factor buffer is adopted into a port SuperFactor through
factor_from_numpy (the plans are identical), so each solve is compared on
the very same factor; the solves then run end to end on the port's own
factor as well.  Tolerance 1e-12 relative: the same substitutions with
sums taken in another order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.cholesky import wave as ref_wave
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.cholesky import wave as port_wave
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.io import generators as port_gen

SYSTEMS = ["A", "LLt", "L", "Lt", "P", "Pt"]


def _factors(program, gen="fem3d", arg=2500):
    """(A, reference common, reference factor, port common, port plan,
    port symbolic) of the same matrix, the reference factored."""
    A = getattr(ref_gen, gen)(arg)
    rcm = ref_common()
    rcm.cholesky.supernodal = "supernodal"
    rcm.cholesky.program = program
    sym = ref_chol.analyze(A, rcm)
    ss = ref_chol.super_symbolic(A, sym, rcm)
    rf = ref_sn.factorize_super(A, sym, ss, common=rcm)
    A2 = getattr(port_gen, gen)(arg)
    pcm = port_common()
    pcm.cholesky.supernodal = "supernodal"
    pcm.cholesky.program = program
    psym = port_chol.analyze(A2, pcm)
    pplan = port_sn.build_plan(port_chol.super_symbolic(A2, psym, pcm))
    return A2, rcm, rf, pcm, pplan, psym


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def pf_case():
    A, rcm, rf, pcm, plan, sym = _factors("pf")
    pf = port_sn.factor_from_numpy(plan, np.asarray(rf.Lx), sym.perm,
                                   device="cpu")
    return A, rcm, rf, pcm, plan, sym, pf


def test_factor_from_numpy_adopts_reference_buffer(pf_case):
    A, rcm, rf, pcm, plan, sym, pf = pf_case
    assert pf.ok and pf.Lx.dtype == torch.float64
    assert np.array_equal(pf.Lx.numpy(), np.asarray(rf.Lx))
    assert np.array_equal(pf.perm, rf.perm)


def test_solve_dinv_matches_reference(pf_case):
    A, rcm, rf, pcm, plan, sym, pf = pf_case
    rwp = rf.plan.wave_plan(solve_only=True)
    pwp = plan.wave_plan(solve_only=True)
    want = np.asarray(ref_wave.solve_dinv(rwp, rf.Lx))
    got = port_wave.solve_dinv(pwp, pf.Lx).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("device_perm", [False, True])
def test_wave_solve_llt_matches_reference(pf_case, k, device_perm):
    A, rcm, rf, pcm, plan, sym, pf = pf_case
    n = A.ncol
    b = np.random.default_rng(k).standard_normal((n, k))
    rwp = rf.plan.wave_plan(solve_only=True)
    pwp = plan.wave_plan(solve_only=True)
    if device_perm:
        invp = np.empty(n, dtype=np.int64)
        invp[sym.perm] = np.arange(n)
        want = np.asarray(ref_wave.wave_solve_llt(
            rwp, rf.Lx, jnp.asarray(b), None, jnp.asarray(sym.perm),
            jnp.asarray(invp)))
        got = port_wave.wave_solve_llt(
            pwp, pf.Lx, torch.from_numpy(b), None,
            torch.from_numpy(sym.perm), torch.from_numpy(invp)).numpy()
        assert got.shape == (n, k)
    else:
        want = np.asarray(ref_wave.wave_solve_llt(rwp, rf.Lx,
                                                  jnp.asarray(b[sym.perm])))
        got = port_wave.wave_solve_llt(pwp, pf.Lx,
                                       torch.from_numpy(b[sym.perm])).numpy()
        want, got = want[:n], got[:n]
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("system", SYSTEMS)
def test_solve_super_on_reference_factor(pf_case, system):
    A, rcm, rf, pcm, plan, sym, pf = pf_case
    b = np.random.default_rng(5).standard_normal((A.ncol, 3))
    want = ref_sn.solve_super(rf, b, system, rcm)
    got = port_sn.solve_super(pf, b, system, pcm)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-12


@pytest.fixture(scope="module", params=["unrolled", "pf"])
def own_factors(request):
    """Reference and port each factor laplacian_3d(9) themselves."""
    A, rcm, rf, pcm, plan, sym = _factors(request.param, "laplacian_3d", 9)
    pf = port_sn.factorize_super(A, sym, plan.ss, plan=plan, common=pcm,
                                 device="cpu")
    return A, rcm, rf, pcm, pf


@pytest.mark.parametrize("system", SYSTEMS)
def test_solve_super_end_to_end(own_factors, system):
    """Port factor + port solve vs reference factor + reference solve,
    for both programs."""
    A, rcm, rf, pcm, pf = own_factors
    b = np.random.default_rng(6).standard_normal(A.ncol)
    want = ref_sn.solve_super(rf, b, system, rcm)
    got = port_sn.solve_super(pf, b, system, pcm)
    assert got.shape == want.shape == (A.ncol,)
    assert _rel(got, want) < 1e-12
    if system == "A":
        assert port_chol.residual_norm(A, got, b) < 1e-14
