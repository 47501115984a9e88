"""Dense kernels of the port (suitesparse_tpu_torch/cholesky/kernels.py)
against the JAX reference (pallas_kernels.py, interpret mode on the CPU).

On the CPU the port's ``block_chol`` runs its plain PyTorch version; the
CUDA kernel is held against that plain version by test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suitesparse_tpu.cholesky import pallas_kernels as ref
from suitesparse_tpu.cholesky.pf import _tri_inv_pow2 as ref_tri_inv

from suitesparse_tpu_torch.cholesky import kernels as port
from suitesparse_tpu_torch.cholesky.pf import _tri_inv_pow2 as port_tri_inv


def _mk_panel(rng, W, Np, Mb, nreal, mreal):
    """The reference kernel tests' panel: SPD diagonal block with junk
    above the diagonal, random below rows, padding masks."""
    Mp = Np + Mb
    P = np.zeros((W, Mp, Np))
    pe = np.zeros((W, Np))
    rm = np.zeros((W, Mp))
    cm = np.zeros((W, Np))
    for w in range(W):
        M = rng.standard_normal((nreal, nreal))
        S = M @ M.T + nreal * np.eye(nreal)
        P[w, :nreal, :nreal] = (np.tril(S)
                                + np.triu(rng.standard_normal(
                                    (nreal, nreal)), 1) * 100)
        if mreal:
            P[w, Np:Np + mreal, :nreal] = rng.standard_normal((mreal, nreal))
        pe[w, nreal:] = 1.0
        rm[w, :nreal] = 1.0
        rm[w, Np:Np + mreal] = 1.0
        cm[w, :nreal] = 1.0
    return P, pe, rm, cm


def _spd_batch(rng, W, Np, npad):
    M = rng.standard_normal((W, Np, Np))
    S = M @ M.transpose(0, 2, 1) / Np + np.eye(Np)
    pe = np.zeros((W, Np))
    if npad:
        S[:, Np - npad:, :] = 0.0
        S[:, :, Np - npad:] = 0.0
        pe[:, Np - npad:] = 1.0
    return S, pe


PANEL_CASES = [
    (4, 8, 0, 7, 0),
    (4, 8, 32, 8, 29),
    (2, 32, 8, 30, 8),
    (2, 32, 128, 27, 125),
    (1, 128, 128, 126, 120),
    (1, 256, 32, 250, 30),
]


@pytest.mark.parametrize("W,Np,Mb,nreal,mreal", PANEL_CASES)
def test_panel_factor_matches_reference(W, Np, Mb, nreal, mreal):
    """Port plain panel_factor vs the JAX panel_factor (Pallas kernel in
    interpret mode), f64.  Tolerance 1e-12 relative: same algorithm, sums
    taken in another order by another backend."""
    rng = np.random.default_rng(Np * 1000 + Mb)
    P, pe, rm, cm = _mk_panel(rng, W, Np, Mb, nreal, mreal)
    want = np.asarray(ref.panel_factor(*map(jnp.asarray, (P, pe, rm, cm))))
    got = port.panel_factor(*map(torch.from_numpy, (P, pe, rm, cm))).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-12
    # exact zeros wherever the reference has them (padding, upper part)
    assert np.array_equal(got == 0, want == 0)


def test_panel_factor_nan_on_indefinite():
    """NOT_POSDEF contract: a negative pivot surfaces as NaN, as in the
    reference."""
    rng = np.random.default_rng(0)
    P, pe, rm, cm = _mk_panel(rng, 1, 8, 0, 6, 0)
    P[0, 3, 3] = -5.0
    want = np.asarray(ref.panel_factor(*map(jnp.asarray, (P, pe, rm, cm))))
    got = port.panel_factor(*map(torch.from_numpy, (P, pe, rm, cm))).numpy()
    assert np.isnan(got[0, :6, :6]).any()
    assert np.isnan(want[0, :6, :6]).any()


@pytest.mark.parametrize("Np", [8, 16, 24, 32, 40, 64, 120, 128])
def test_block_chol_plain_matches_reference(Np):
    """U = chol(S + diag(pe))^T with exact zeros below the diagonal."""
    rng = np.random.default_rng(Np)
    S, pe = _spd_batch(rng, 3, Np, Np // 8)
    want = np.asarray(ref.block_chol(jnp.asarray(S), jnp.asarray(pe)))
    before = port.block_chol.launches
    got = port.block_chol(torch.from_numpy(S), torch.from_numpy(pe)).numpy()
    assert port.block_chol.launches == before    # CPU: plain, no launch
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-12
    assert np.all(np.tril(got, -1) == 0)
    L = np.linalg.cholesky(S + pe[:, :, None] * np.eye(Np))
    assert np.abs(got - L.transpose(0, 2, 1)).max() <= 1e-12 * np.abs(L).max()


@pytest.mark.parametrize("Np", [8, 32, 128])
def test_tri_inverses_match_reference(Np):
    """Batch-folded triangular inverses (closed-form 2x2 base), lower
    (pf._tri_inv_pow2) and upper (_tri_inv_upper_pow2)."""
    rng = np.random.default_rng(7 + Np)
    L = np.tril(rng.standard_normal((5, Np, Np))) + 4 * np.eye(Np)
    want = np.asarray(ref_tri_inv(jnp.asarray(L)))
    got = port_tri_inv(torch.from_numpy(L)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-12
    assert np.abs(got @ L - np.eye(Np)).max() <= 1e-10
    U = L.transpose(0, 2, 1).copy()
    want_u = np.asarray(ref._tri_inv_upper_pow2(jnp.asarray(U)))
    got_u = port._tri_inv_upper_pow2(torch.from_numpy(U)).numpy()
    assert np.abs(got_u - want_u).max() / np.abs(want_u).max() <= 1e-12


def test_block_chol_refuses_other_devices():
    """A tensor on neither the CPU nor the card is refused, not copied to
    a device the wrapper can serve."""
    S = torch.zeros((2, 12, 12), device="meta")
    with pytest.raises(ValueError):
        port.block_chol(S, torch.zeros((2, 12), device="meta"))
