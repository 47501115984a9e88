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
from suitesparse_tpu_torch.ops import spmv


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
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("Np", range(8, 129, 8))
def test_block_chol_cuda_kernel_matches_plain(Np, dtype, tol):
    """The CUDA kernel vs its plain version on the card, every Np the
    kernel takes (ragged last panels included), W in {1, 4, 37, 512}: the
    same rank-1 updates in the same column order, rounded differently
    (fused multiply-adds, device rsqrt), so ~Np ulp apart at worst."""
    _need_card()
    rng = np.random.default_rng(Np)
    for W in (1, 4, 37, 512):
        S, pe = _spd_batch(rng, W, Np, Np // 8)
        S = torch.as_tensor(S, dtype=dtype, device="cuda")
        pe = torch.as_tensor(pe, dtype=dtype, device="cuda")
        before = kernels.block_chol.launches
        K = kernels.block_chol(S, pe)
        assert kernels.block_chol.launches == before + 1
        P = kernels.block_chol_plain(S, pe)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(K).all())
        assert float((K - P).abs().max() / P.abs().max()) <= tol
        assert bool((torch.tril(K, -1) == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("Np", range(8, 129, 8))
def test_block_chol_cuda_nan_pattern_matches_plain(Np, dtype):
    """A negative pivot in the first, a middle and the last panel (columns
    1, Np / 2 and Np - 3 of matrices 1-3 of the batch): the kernel's NaN
    pattern is the plain version's, and the definite matrix 0 stays
    finite."""
    _need_card()
    S, pe = _spd_batch(np.random.default_rng(100 + Np), 4, Np, 0)
    for w, c in ((1, 1), (2, Np // 2), (3, Np - 3)):
        S[w, c, c] = -5.0
    S = torch.as_tensor(S, dtype=dtype, device="cuda")
    pe = torch.as_tensor(pe, dtype=dtype, device="cuda")
    K = kernels.block_chol(S, pe)
    P = kernels.block_chol_plain(S, pe)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(K), torch.isnan(P))
    assert bool(torch.isfinite(K[0]).all())
    assert all(bool(torch.isnan(K[w]).any()) for w in (1, 2, 3))


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


@pytest.mark.gpu
def test_bcsr_spmm_cuda_kernel_matches_plain():
    """The BCSR kernel vs its plain version on the card, float32, 1e-5
    relative, and vs scipy in float64: both sum up to 128 * nslots
    products in another order, the kernel's as three TF32 products each
    (~2^-20).  Cases: one block, m and n not multiples of 128, rows with
    pad slots, k in {1, 7, 32, 50, 64, 128, 130, 256} (every column tile,
    16-byte X copies where k % 4 == 0, 4-byte ones otherwise), and an X
    that is not 16-byte aligned at k = 32 (the 4-byte path)."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    _need_card()
    rng = np.random.default_rng(4)
    for m, n, d, k, aligned in (
            (90, 100, 0.3, 1, True), (1000, 700, 0.01, 50, True),
            (1000, 700, 0.01, 130, True), (700, 1100, 0.0001, 7, True),
            (1000, 700, 0.01, 32, True), (3000, 2500, 0.002, 64, True),
            (600, 900, 0.02, 128, True), (500, 400, 0.03, 256, True),
            (1000, 700, 0.01, 32, False)):
        S = sp.random(m, n, d, random_state=rng, format="csc")
        bc = spmv.to_bcsr(SparseCSC.from_scipy(S))
        Xh = rng.standard_normal((n, k))
        if aligned:
            X = torch.as_tensor(Xh, dtype=torch.float32, device="cuda")
        else:
            flat = torch.empty(n * k + 1, device="cuda")
            X = flat[1:].view(n, k)
            X.copy_(torch.as_tensor(Xh))
            assert X.data_ptr() % 16
        before = spmv.bcsr_spmm.launches
        Y = spmv.bcsr_spmm(bc, X)
        assert spmv.bcsr_spmm.launches == before + 1
        blocks, cols = bc.device_arrays(X.device)
        P = spmv.bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
        torch.cuda.synchronize()
        assert Y.shape == (m, k) and Y.dtype == torch.float32
        assert float((Y - P).abs().max() / P.abs().max()) <= 1e-5
        ref = S @ X.double().cpu().numpy()
        assert float(np.abs(Y.cpu().numpy() - ref).max()
                     / np.abs(ref).max()) <= 1e-5


@pytest.mark.gpu
def test_bcsr_spmm_cuda_inf_nan_pattern_matches_plain():
    """Inf and NaN in A (a NaN with a payload only in its low bits among
    them), in X and in X's block 0, which pad slots multiply: the kernel's
    isnan and isinf patterns, and the signs of its infinities, are the
    plain version's (the CPU rehearsal of the split checks the same case
    in tests/test_torch_bcsr_split.py)."""
    from suitesparse_tpu_torch.tools.bench_bcsr import inf_nan_case
    _need_card()
    bc, Xh = inf_nan_case(np.random.default_rng(11))
    X = torch.as_tensor(Xh, device="cuda")
    Y = spmv.bcsr_spmm(bc, X)
    blocks, cols = bc.device_arrays(X.device)
    P = spmv.bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
    torch.cuda.synchronize()
    assert bool(torch.isnan(P).any()) and bool(torch.isinf(P).any())
    assert torch.equal(torch.isnan(Y), torch.isnan(P))
    assert torch.equal(torch.isinf(Y), torch.isinf(P))
    assert torch.equal(torch.sign(Y[torch.isinf(Y)]),
                       torch.sign(P[torch.isinf(P)]))
    fin = torch.isfinite(P)
    assert float((Y[fin] - P[fin]).abs().max() / P[fin].abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 32, 128, 256])
def test_bcsr_spmm_cuda_repeat_is_bit_identical(k):
    """No atomics and no split of a row's slots: a repeated product is
    bit-identical."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    _need_card()
    rng = np.random.default_rng(40 + k)
    S = sp.random(3000, 2500, 0.002, random_state=rng, format="csc")
    bc = spmv.to_bcsr(SparseCSC.from_scipy(S))
    X = torch.as_tensor(rng.standard_normal((2500, k)), dtype=torch.float32,
                        device="cuda")
    Y = spmv.bcsr_spmm(bc, X)
    for _ in range(3):
        assert torch.equal(spmv.bcsr_spmm(bc, X), Y)


@pytest.mark.gpu
def test_bcsr_spmm_cuda_rejects_other_block_sizes():
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    _need_card()
    S = sp.random(200, 200, 0.05, random_state=np.random.default_rng(5),
                  format="csc")
    bc = spmv.to_bcsr(SparseCSC.from_scipy(S), bm=64, bk=64)
    with pytest.raises(ValueError):
        spmv.bcsr_spmm(bc, torch.ones((200, 4), device="cuda"))


@pytest.mark.gpu
def test_dispatch_probe_kernels_match_plain():
    """scale_blocks and scale_gather vs their plain versions on the card,
    bit for bit (one float32 multiply by the same constant).  G in {1, 3,
    64, 131, 256, 257}: chunk counts that are no multiple of the grid, and
    grids smaller than the SM count.  Offsets reversed, random and sparse
    (windows at unaligned offsets that leave rows uncovered: only the
    named rows are compared)."""
    from suitesparse_tpu_torch.tools import microbench_dispatch as probe
    _need_card()
    rng = np.random.default_rng(6)
    for G in (1, 3, 64, 131, 256, 257):
        rows = G * probe.ROWS
        buf = torch.as_tensor(rng.standard_normal((rows, probe.COLS)),
                              dtype=torch.float32, device="cuda")
        P = probe.scale_blocks_plain(buf, G)
        before = probe.scale_blocks.launches
        K = probe.scale_blocks(buf, G)
        assert probe.scale_blocks.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(K, P)
        for offs in (np.arange(G)[::-1] * probe.ROWS,
                     rng.permutation(G) * probe.ROWS,
                     probe.sparse_offsets(rng, G)):
            table = probe.GatherTable(offs, rows)
            named = table.row_index(buf.device)
            before = probe.scale_gather.launches
            Kg = probe.scale_gather(table, buf)
            assert probe.scale_gather.launches == before + 1
            torch.cuda.synchronize()
            Pg = probe.scale_gather_plain(table, buf)
            assert torch.equal(Kg[named], Pg[named])
            assert torch.equal(Kg[named], P[named])


@pytest.mark.gpu
def test_dispatch_probe_kernels_refuse_bad_launches():
    """Offsets on the card or overlapping are refused on the host; a buffer
    that is not 16-byte aligned passes the wrapper's checks and is refused
    by the kernel's launch, which raises with the library's error."""
    from suitesparse_tpu_torch.tools import microbench_dispatch as probe
    _need_card()
    buf = torch.zeros((2 * probe.ROWS, probe.COLS), device="cuda")
    with pytest.raises(ValueError):
        probe.scale_gather(torch.zeros(2, dtype=torch.int32, device="cuda"),
                           buf)
    with pytest.raises(ValueError):
        probe.scale_gather(np.array([0, probe.ROWS - 8]), buf)
    flat = torch.zeros(2 * probe.ROWS * probe.COLS + 1, device="cuda")
    skewed = flat[1:].view(2 * probe.ROWS, probe.COLS)
    with pytest.raises(RuntimeError, match="launch"):
        probe.scale_blocks(skewed, 2)


@pytest.mark.gpu
def test_wave_and_bf16_factors_on_card_match_cpu():
    """laplacian_3d(10) on the card against the plain CPU run: the wave
    program and syrk_bf16 (pf) in float64, where the card's bf16 SYRK
    rounds the inputs and multiplies in float64 as the CPU does (1e-12);
    syrk_bf16 in float32, where the card runs one bf16 product with float32
    output on the tensor cores and the CPU multiplies the rounded inputs
    in float32 (the same products, summed in another order: 1e-4)."""
    _need_card()
    A = laplacian_3d(10)
    for program, bf16, dtype, tol in (("wave", False, np.float64, 1e-12),
                                      ("pf", True, np.float64, 1e-12),
                                      ("pf", True, np.float32, 1e-4)):
        cm = default_common()
        cm.cholesky.supernodal = "supernodal"
        cm.cholesky.program = program
        cm.cholesky.syrk_bf16 = bf16
        sym = analyze(A, cm)
        ss = super_symbolic(A, sym, cm)
        fg = factorize_super(A, sym, ss, common=cm, dtype=dtype)
        fc = factorize_super(A, sym, ss, common=cm, dtype=dtype,
                             device="cpu")
        assert fg.ok and fg.Lx.device.type == "cuda"
        t = fg.plan.total
        got, want = fg.Lx[:t].cpu(), fc.Lx[:t]
        assert float((got - want).abs().max() / want.abs().max()) <= tol
