"""The port's backward-stable TRSM option (Common.cholesky.trsm_inv=False)
against the JAX reference's XLA path with SSTPU_TRSM_INV=0
(SSTPU_POTRF=xla), f64 on the CPU.

With the option off, every factor wave takes torch.linalg's Cholesky and
triangular solve instead of panel_factor (block_chol and the explicit
inverse), as the reference's XLA path takes cholesky and
triangular_solve; on the reference's Pallas path SSTPU_TRSM_INV alone
changes nothing.  In float64 the two branches
agree to ~1e-16, so the tests also show which branch ran: panel_factor is
replaced by one that raises (or counts its calls)."""
import numpy as np
import pytest
import torch

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu.cholesky import pf as ref_pf
from suitesparse_tpu.cholesky import super_numeric as ref_sn
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
from suitesparse_tpu_torch.cholesky import pf as port_pf
from suitesparse_tpu_torch.cholesky import super_numeric as port_sn
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.io import generators as port_gen


def _setup(chol, gen, common, sn, pf, **opts):
    A = gen.laplacian_3d(8)
    cm = common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    for k, v in opts.items():
        setattr(cm.cholesky, k, v)
    sym = chol.analyze(A, cm)
    ss = chol.super_symbolic(A, sym, cm)
    plan = sn.build_plan(ss)
    return (A, cm, sym, ss, plan, pf.build_pf_plan(plan, cm),
            sn._assemble_values(A, sym, ss, np.float64))


def _refuse(*args, **kwargs):
    raise AssertionError("panel_factor called with trsm_inv=False")


def _counting(calls):
    real = port_pf.panel_factor

    def wrapped(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    return wrapped


def test_pf_trsm_inv_false_matches_reference_toggle(monkeypatch):
    """pf_numeric(trsm_inv=False) vs the reference's pf_numeric under
    SSTPU_POTRF=xla and SSTPU_TRSM_INV=0 on laplacian_3d(8), entry by entry to 1e-13 relative
    (tests/test_pf.py's bound for the toggle); panel_factor never runs."""
    *_, rp, rq, rv = _setup(ref_chol, ref_gen, ref_common, ref_sn, ref_pf)
    *_, pp, pq, pv = _setup(port_chol, port_gen, port_common, port_sn,
                            port_pf)
    monkeypatch.setenv("SSTPU_POTRF", "xla")
    monkeypatch.setenv("SSTPU_TRSM_INV", "0")
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64))
    monkeypatch.setattr(port_pf, "panel_factor", _refuse)
    got = port_pf.pf_numeric(pv, pq, np.float64, device="cpu",
                             trsm_inv=False)
    assert got.dtype == torch.float64 and got.shape == (pq.buf,)
    t = rp.total
    err = (np.abs(got.numpy()[:t] - want[:t]).max()
           / max(np.abs(want[:t]).max(), 1.0))
    assert err < 1e-13


def test_pf_trsm_inv_default_takes_panel_factor(monkeypatch):
    """The default (trsm_inv=True) still factors every wave of
    laplacian_3d(8) through panel_factor, and the two branches agree to
    1e-13 relative."""
    *_, pp, pq, pv = _setup(port_chol, port_gen, port_common, port_sn,
                            port_pf)
    calls = []
    monkeypatch.setattr(port_pf, "panel_factor", _counting(calls))
    inv = port_pf.pf_numeric(pv, pq, np.float64, device="cpu")
    nf = len(pq.fmeta)
    waves = sum(1 for c in pq.instr_cls.tolist() if c < nf)
    assert len(calls) == waves > 0
    calls.clear()
    tri = port_pf.pf_numeric(pv, pq, np.float64, device="cpu",
                             trsm_inv=False)
    assert not calls
    t = pp.total
    assert float((inv[:t] - tri[:t]).abs().max()
                 / max(float(tri[:t].abs().max()), 1.0)) < 1e-13


@pytest.mark.parametrize("trsm_inv", [True, False])
def test_factorize_super_trsm_inv_field(monkeypatch, trsm_inv):
    """factorize_super through Common: the field reaches the factor (with
    False, panel_factor never runs), and both settings solve
    laplacian_3d(8) to the same residual."""
    A, cm, sym, ss, plan, _, _ = _setup(port_chol, port_gen, port_common,
                                        port_sn, port_pf)
    b = np.arange(A.ncol, dtype=np.float64) % 7 + 1
    ref = port_chol.factorize_super(A, sym, ss, plan=plan, common=cm,
                                    device="cpu")
    r0 = port_chol.residual_norm(
        A, port_chol.solve_super(ref, b, "A", cm), b)
    cm.cholesky.trsm_inv = trsm_inv
    calls = []
    monkeypatch.setattr(port_pf, "panel_factor",
                        _counting(calls) if trsm_inv else _refuse)
    f = port_chol.factorize_super(A, sym, ss, plan=plan, common=cm,
                                  device="cpu")
    assert f.ok and bool(calls) == trsm_inv
    r = port_chol.residual_norm(A, port_chol.solve_super(f, b, "A", cm), b)
    assert r < 1e-14 and r0 < 1e-14
    assert abs(r - r0) <= 1e-15
