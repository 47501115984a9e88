"""The port's pass-forward factor program (suitesparse_tpu_torch/cholesky/
pf.py) against the JAX reference's pf_numeric, f64 on the CPU.

Same plan, same panels: the port's flat buffer must match the reference's
entry by entry to 1e-13 relative (the two differ only in the order of
floating-point sums, and the port factors every diagonal block through
panel_factor/block_chol where the reference's CPU default takes XLA's
cholesky)."""
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


def _both(gen, arg, **opts):
    """(reference, port) of (plan, pf plan, assembled f64 values)."""
    out = []
    for chol, gens, common, sn, pf in (
            (ref_chol, ref_gen, ref_common, ref_sn, ref_pf),
            (port_chol, port_gen, port_common, port_sn, port_pf)):
        A = getattr(gens, gen)(arg)
        cm = common()
        cm.cholesky.supernodal = "supernodal"
        for k, v in opts.items():
            setattr(cm.cholesky, k, v)
        sym = chol.analyze(A, cm)
        ss = chol.super_symbolic(A, sym, cm)
        plan = sn.build_plan(ss)
        out.append((plan, pf.build_pf_plan(plan, cm),
                    sn._assemble_values(A, sym, ss, np.float64)))
    return out


def _rel(got, want, total):
    return (np.abs(got[:total] - want[:total]).max()
            / max(np.abs(want[:total]).max(), 1.0))


@pytest.mark.parametrize("gen,arg", [("laplacian_2d", 20),
                                     ("laplacian_3d", 8),
                                     ("laplacian_3d", 12)])
@pytest.mark.parametrize("mode", ["project", "scatter", "auto"])
def test_pf_numeric_matches_reference(gen, arg, mode):
    (rp, rq, rv), (pp, pq, pv) = _both(gen, arg, pf_mode=mode)
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64))
    got = port_pf.pf_numeric(pv, pq, np.float64, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (pq.buf,)
    assert _rel(got.numpy(), want, rp.total) < 1e-13


def test_pf_numeric_matches_reference_pallas(monkeypatch):
    """Reference run through its Pallas panel factor (interpret mode)."""
    monkeypatch.setenv("SSTPU_POTRF", "pallas")
    (rp, rq, rv), (pp, pq, pv) = _both("laplacian_3d", 8)
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64))
    got = port_pf.pf_numeric(pv, pq, np.float64, device="cpu").numpy()
    assert _rel(got, want, rp.total) < 1e-13


def test_pf_refactorization_is_repeatable_and_reuses_plan():
    """Values change, pattern fixed: the same plan gives the new factor,
    and a repeated factorization is bit-identical."""
    (_, _, _), (pp, pq, pv) = _both("laplacian_3d", 8)
    F1 = port_pf.pf_numeric(pv, pq, np.float64, device="cpu")
    F1b = port_pf.pf_numeric(pv, pq, np.float64, device="cpu")
    F2 = port_pf.pf_numeric(pv * 4.0, pq, np.float64, device="cpu")
    assert torch.equal(F1, F1b)
    t = pp.total
    assert torch.allclose(F2[:t], 2.0 * F1[:t], rtol=0, atol=1e-12)


@pytest.mark.parametrize("gen,arg", [("laplacian_3d", 12),
                                     ("laplacian_3d", 16)])
def test_pf_numeric_bf16_matches_reference(gen, arg):
    """syrk_bf16 at both of its pf sites -- the factor step's SYRK and the
    pair projection's placement (laplacian_3d(16) has pair instructions
    of every kind, one-hot and gather placement both) -- in float64:
    1e-12 relative to the reference's bfloat16 run, and visibly off the
    plain factor."""
    (rp, rq, rv), (pp, pq, pv) = _both(gen, arg)
    assert len(pq.qmeta) > 0
    want = np.asarray(ref_pf.pf_numeric(rv, rq, np.float64, syrk_bf16=True))
    got = port_pf.pf_numeric(pv, pq, np.float64, syrk_bf16=True,
                             device="cpu").numpy()
    assert _rel(got, want, rp.total) < 1e-12
    plain = port_pf.pf_numeric(pv, pq, np.float64, device="cpu").numpy()
    assert 1e-6 < _rel(got, plain, rp.total) < 1e-2
