"""Tests of the port that need a CUDA device (marker ``gpu``); each skips
without one.  This file imports neither jax nor the JAX package, so that on
a machine with a card and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from suitesparse_tpu_torch.cholesky import (analyze, factorize_super,
                                            residual_norm, solve_super,
                                            super_symbolic)
from suitesparse_tpu_torch.cholesky import kernels
from suitesparse_tpu_torch.core.common import default_common
from suitesparse_tpu_torch.io.generators import laplacian_3d


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _spd_batch(rng, W, Np, npad):
    M = rng.standard_normal((W, Np, Np))
    S = M @ M.transpose(0, 2, 1) / Np + np.eye(Np)
    pe = np.zeros((W, Np))
    if npad:
        S[:, Np - npad:, :] = 0.0
        S[:, :, Np - npad:] = 0.0
        pe[:, Np - npad:] = 1.0
    return S, pe


@pytest.mark.gpu
def test_block_chol_cuda_kernel_matches_plain():
    """The CUDA kernel vs its plain version on the card, every Np of the
    ladders, f64 (1e-12) and f32 (1e-5): the same rank-1 updates, rounded
    differently (fused multiply-add, device rsqrt)."""
    _need_card()
    rng = np.random.default_rng(3)
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for Np in (8, 16, 32, 64, 128):
            for W in (1, 37, 512):
                S, pe = _spd_batch(rng, W, Np, Np // 8)
                S = torch.as_tensor(S, dtype=dt, device="cuda")
                pe = torch.as_tensor(pe, dtype=dt, device="cuda")
                before = kernels.block_chol.launches
                K = kernels.block_chol(S, pe)
                assert kernels.block_chol.launches == before + 1
                P = kernels.block_chol_plain(S, pe)
                torch.cuda.synchronize()
                assert float((K - P).abs().max() / P.abs().max()) <= tol
                assert bool((torch.tril(K, -1) == 0).all())
        S, pe = _spd_batch(rng, 4, 32, 0)
        S[1, 5, 5] = -5.0
        K = kernels.block_chol(torch.as_tensor(S, dtype=dt, device="cuda"),
                               torch.as_tensor(pe, dtype=dt, device="cuda"))
        assert bool(torch.isnan(K[1]).any())
        assert bool(torch.isfinite(K[[0, 2, 3]]).all())


@pytest.mark.gpu
def test_block_chol_cuda_rejects_bad_shapes():
    _need_card()
    for Np in (12, 136):
        S = torch.zeros((2, Np, Np), device="cuda")
        with pytest.raises(ValueError):
            kernels.block_chol(S, torch.zeros((2, Np), device="cuda"))


@pytest.mark.gpu
def test_factor_on_card_matches_cpu():
    """laplacian_3d(10), f64, pass-forward program: the factor on the card
    (through the kernel) matches the plain CPU run to 1e-12 relative."""
    _need_card()
    A = laplacian_3d(10)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    before = kernels.block_chol.launches
    fg = factorize_super(A, sym, ss, common=cm, dtype=np.float64)
    assert kernels.block_chol.launches > before
    fc = factorize_super(A, sym, ss, common=cm, device="cpu")
    t = fg.plan.total
    got, want = fg.Lx[:t].cpu(), fc.Lx[:t]
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12
    b = np.random.default_rng(0).standard_normal(A.ncol)
    assert residual_norm(A, solve_super(fg, b, "A", cm), b) < 1e-14
