"""Tests of the port that need a CUDA device (marker ``gpu``); each skips
without one.  This file imports neither jax nor the JAX package, so that on
a machine with a card and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from chip_smoke import (cd3d, host_syncs, omega, one_sync_bfs,
                        one_sync_pagerank, ring_chords, tree_equal)
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


def _lu_matrix(name):
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.io.generators import random_unsym
    if name == "cd3d_10":
        return cd3d(10)
    A = random_unsym(300, 0.05, seed=3)
    if name == "complex":
        S = A.to_scipy() + 1j * sp.random(
            300, 300, 0.02, random_state=np.random.default_rng(4)) \
            + 2j * sp.identity(300)
        A = SparseCSC.from_scipy(sp.csc_matrix(S))
    return A


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cd3d_10", "random_unsym", "complex"])
def test_umf_on_card_matches_cpu(name):
    """umf_numeric on the card (float32 / complex64) against the port's
    CPU float64 factor: raw solves within 1e-4, and omega <= 1e-11 after
    3 float64 refinement steps without escalation; refactors on the card
    are bit-identical."""
    _need_card()
    from suitesparse_tpu_torch.lu import umf_numeric, umf_solve, umf_symbolic
    A = _lu_matrix(name)
    cm = default_common()
    cm.lu.singletons = False
    S = umf_symbolic(A, cm)
    ng = umf_numeric(A, S, cm)
    assert ng.Lb.device.type == "cuda" and not ng.singular
    assert ng.Lb.dtype == (torch.complex64 if name == "complex"
                           else torch.float32)
    nc = umf_numeric(A, S, cm, device="cpu")
    again = umf_numeric(A, S, cm)
    assert torch.equal(ng.Lb, again.Lb) and torch.equal(ng.Ub, again.Ub)
    assert all(torch.equal(p, q) for lp, lq in zip(ng.pivs, again.pivs)
               for p, q in zip(lp, lq))
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.ncol)
    for system in ("A", "At", "Aat"):
        xg = umf_solve(ng, b, system, refine=0)
        xc = umf_solve(nc, b, system, refine=0)
        assert np.abs(xg - xc).max() <= 1e-4 * np.abs(xc).max(), system
    for system in ("A", "At"):
        cs = default_common()
        x = umf_solve(ng, b, system, refine=3, A=A, common=cs)
        assert "umf_escalated" not in cs.info
        assert omega(A, x, b, system) <= 1e-11, system


@pytest.mark.gpu
def test_umf_singular_flag_on_card():
    """A zero row (stored zeros) reaching the device numeric is flagged."""
    _need_card()
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.core.status import Status
    from suitesparse_tpu_torch.lu import umf_numeric, umf_symbolic
    A = cd3d(8)
    data = A.data.copy()
    data[A.indices == 200] = 0.0
    A0 = SparseCSC(A.indptr, A.indices, data, A.shape)
    cm = default_common()
    cm.lu.singletons = False
    num = umf_numeric(A0, umf_symbolic(A0, cm), cm)
    assert num.singular and cm.status == Status.SINGULAR
    ok = umf_numeric(A, umf_symbolic(A, cm), cm)
    assert not ok.singular and cm.status == Status.OK


@pytest.mark.gpu
def test_klu_device_on_card_matches_cpu():
    """klu_device on the card (float32) against the CPU (float64):
    factors and solutions within 1e-4, a batched sweep, bit-identical
    repeats, and a zero pivot that flips ok."""
    _need_card()
    from suitesparse_tpu_torch.io.generators import circuit_like
    from suitesparse_tpu_torch.lu import klu_analyze, klu_device, klu_factor
    A = circuit_like(300, seed=3)
    sym = klu_analyze(A)
    num = klu_factor(A, sym)
    _, rg, sg = klu_device(A, sym, num)
    _, rc, sc = klu_device(A, sym, num, device="cpu")
    fg, Rg, okg = rg(A.data)
    fc, Rc, okc = rc(A.data)
    assert fg[0].dtype == torch.float32 and bool(okg) and bool(okc)
    for a, c in zip(fg, fc):
        assert float((a.double().cpu() - c).abs().max()
                     / c.abs().max()) <= 1e-4
    again = rg(A.data)
    assert all(torch.equal(a, c) for a, c in zip(fg, again[0]))
    b = np.random.default_rng(6).standard_normal(A.ncol)
    xg = sg(fg, Rg, A.data, b).double().cpu().numpy()
    xc = sc(fc, Rc, A.data, b).numpy()
    assert np.abs(xg - xc).max() <= 1e-4 * np.abs(xc).max()
    scale = np.random.default_rng(7).uniform(0.9, 1.1, (4, A.nnz))
    vals = torch.as_tensor(A.data * scale, dtype=torch.float32,
                           device="cuda")
    fs, Rs, oks = rg(vals)
    xs = sg(fs, Rs, vals, b)
    assert xs.shape == (4, A.ncol) and bool(oks.all())
    for s in range(4):
        S = A.to_scipy().copy()
        S.data = S.data * scale[s]
        x = xs[s].double().cpu().numpy()
        assert residual_norm(type(A).from_scipy(S), x, b) <= 1e-4
    zero = A.data.copy()
    j = int(sym.q[0])
    zero[A.indptr[j]:A.indptr[j + 1]] = 0.0
    assert not bool(rg(zero)[2])


def _qr_tall(m, n, seed, complex_=False):
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=0.05, random_state=rng, format="csc")
    S = S + sp.csc_matrix((np.ones(n) * 0.5,
                           (rng.integers(0, m, n), np.arange(n))),
                          shape=(m, n))
    if complex_:
        S = S + 1j * sp.random(m, n, density=0.02, random_state=rng)
    return SparseCSC.from_scipy(sp.csc_matrix(S))


@pytest.mark.gpu
@pytest.mark.parametrize("complex_", [False, True])
def test_qr_on_card_matches_cpu(complex_):
    """qr_factorize / qr_solve on the card (float32 / complex64) against
    the port's own CPU float64 run on a small tall matrix: solutions and
    |diag R| within 1e-5, the same rank; refactors bit-identical (R and
    Q'b), and R without b equal to R with b (mode "r" vs "reduced")."""
    _need_card()
    from suitesparse_tpu_torch.qr import (qr_factorize, qr_qmult, qr_solve,
                                          qr_symbolic, r_diagonal)
    A = _qr_tall(600, 300, 11, complex_)
    S = qr_symbolic(A)
    rng = np.random.default_rng(12)
    b = rng.standard_normal(600)
    g = qr_factorize(A, S, b=b)
    assert g.Rbuf.device.type == "cuda"
    assert g.Rbuf.dtype == (torch.complex64 if complex_ else torch.float32)
    again = qr_factorize(A, S, b=b)
    assert torch.equal(g.Rbuf, again.Rbuf)
    assert np.array_equal(g.qtb, again.qtb)
    assert torch.equal(qr_factorize(A, S).Rbuf, g.Rbuf)
    c = qr_factorize(A, S, b=b, device="cpu")
    assert g.rank == c.rank == 300
    dg = np.abs(r_diagonal(S, g.Rbuf))
    dc = np.abs(r_diagonal(S, c.Rbuf))
    assert np.abs(dg - dc).max() <= 1e-5 * dc.max()
    xg = qr_solve(A, b)
    xc = qr_solve(A, b, device="cpu")
    assert np.abs(xg - xc).max() <= 1e-5 * np.abs(xc).max()
    k = qr_factorize(A, S, keep_q=True)
    X = rng.standard_normal((600, 3))
    Y = qr_qmult(k, X, "QTX")
    assert np.abs(qr_qmult(k, Y, "QX") - X).max() <= 1e-5 * np.abs(X).max()


@pytest.mark.gpu
def test_factorize_raises_when_block_chol_launch_fails(monkeypatch):
    """With block_chol's launch forced to fail, backslash on an SPD matrix
    raises instead of returning an LU solution; unpatched, the same call
    launches block_chol and solves."""
    _need_card()
    from suitesparse_tpu_torch.models import Factorize, backslash
    from suitesparse_tpu_torch.utils import cuda_build
    A = laplacian_3d(8)
    b = np.ones(A.ncol)

    def common():
        cm = default_common()
        cm.cholesky.program = "pf"          # the program that runs block_chol
        return cm

    before = kernels.block_chol.launches
    F = Factorize(A, common())
    assert F.kind == "cholesky" and kernels.block_chol.launches > before
    assert residual_norm(A, F.solve(b), b) <= 1e-5

    def fail(*args, **kw):
        raise RuntimeError("forced launch failure")

    monkeypatch.setattr(cuda_build, "launch", fail)
    with pytest.raises(RuntimeError, match="forced launch failure"):
        backslash(A, b, common())


@pytest.mark.gpu
def test_distributed_two_ranks_on_one_card(tmp_path):
    """Two gloo ranks sharing the card factor laplacian_3d(12) in float32
    (3 refactorizations bit-identical, checked by the ranks; gloo stages
    the CUDA tensors through host memory), against the same two ranks'
    float64 run on the CPU: own regions and top within 1e-5 relative, the
    solve within 1e-4 (cond ~60 at float32 precision)."""
    _need_card()
    from suitesparse_tpu_torch.tools.multihost_dryrun import launch
    case = dict(kind="dist", gen="laplacian_3d", arg=12, reps=3, seed=5,
                save=True, root_2d_min=64, root_2d_nb=32, pairs=1)
    out = {}
    for device, dtype in (("cuda", "float32"), ("cpu", "float64")):
        res = launch(2, dict(backend="gloo", device=device,
                             cases=[dict(case, dtype=dtype)]),
                     str(tmp_path / device), timeout=300)
        assert all(r["dist"]["status"] == 0 for r in res)
        assert res[0]["device"].startswith(device)
        # every rank program ran as a replay on the card, held by the rank
        # against its eager body (sync-free) bit for bit
        assert all(row["replayed"] == (device == "cuda")
                   for r in res for row in r["dist"]["program_pairs"])
        out[device] = [dict(np.load(tmp_path / device / f"rank{r}.npz"))
                       for r in range(2)]
    assert res[0]["dist"]["top_fan"] and res[0]["dist"]["root"]
    for g, c in zip(out["cuda"], out["cpu"]):
        for key, tol in (("own", 1e-5), ("top", 1e-5), ("x", 1e-4)):
            ref = c[key]
            err = np.abs(g[key].astype(np.float64) - ref).max()
            assert err <= tol * np.abs(ref).max(), (key, err)


@pytest.fixture(scope="module")
def card_programs():
    """Every device program of the slice, prepared on the card through
    the public entry points on small inputs: {name: (program, inputs)},
    the inputs copies of the program's static buffers."""
    _need_card()
    from suitesparse_tpu_torch.cholesky.super_numeric import (
        build_plan, factor_program)
    from suitesparse_tpu_torch.io.generators import circuit_like
    from suitesparse_tpu_torch.lu import (klu_analyze, klu_device,
                                          klu_factor, umf_numeric,
                                          umf_solve, umf_symbolic)
    progs = {}

    def take(name, cache):
        for key, prog in cache.items():
            if hasattr(prog, "static") and prog.prepared:
                progs[f"{name} {key[0]} {key[1:-1]}"] = (
                    prog, tuple(t.clone() for t in prog.static))

    A = laplacian_3d(10)
    b = np.random.default_rng(0).standard_normal((A.ncol, 4))
    for opts in (dict(program="pf"), dict(program="pf", syrk_bf16=True),
                 dict(program="pf", trsm_inv=False), dict(program="wave"),
                 dict(program="unrolled")):
        cm = default_common()
        cm.cholesky.supernodal = "supernodal"
        for k, v in opts.items():
            setattr(cm.cholesky, k, v)
        sym = analyze(A, cm)
        ss = super_symbolic(A, sym, cm)
        plan = build_plan(ss)
        f = factorize_super(A, sym, ss, plan=plan, common=cm)
        assert f.ok
        for system in ("A", "LLt", "L", "Lt"):
            solve_super(f, b[:, 0], system, cm)
            solve_super(f, b, system, cm)
        prog = factor_program(plan, cm, np.float32, "cuda")
        progs[f"factor {opts}"] = (prog, tuple(t.clone()
                                               for t in prog.static))
        take(f"{opts}", plan._cache)
        if plan._wave is not None:
            take(f"{opts} wave plan", plan._wave._cache)
    cmu = default_common()
    C = cd3d(8)
    num = umf_numeric(C, umf_symbolic(C, cmu), cmu)
    for system in ("A", "At"):
        umf_solve(num, b[:C.ncol], system, refine=0)
    take("umf", num.symbolic.plan._cache)
    K = circuit_like(300, seed=3)
    ksym = klu_analyze(K)
    kplan, refactor, solve = klu_device(K, ksym, klu_factor(K, ksym))
    sweep = torch.as_tensor(K.data[None] * np.linspace(0.9, 1.1, 4)[:, None],
                            dtype=torch.float32, device="cuda")
    for av in (K.data, sweep):
        fs, Rs, _ = refactor(av)
        solve(fs, Rs, av, b[:K.ncol, 0])
    take("klu", kplan._cache)
    from suitesparse_tpu_torch.graphblas import bfs_levels, pagerank
    G = ring_chords(3000, 21)
    pagerank(G, max_iter=20)
    bfs_levels(G, 0)
    take("graph", G._loop_programs)
    assert len(progs) >= 40
    return progs


@pytest.mark.gpu
def test_program_replay_is_bit_identical_to_its_eager_body(card_programs):
    """Each program's replay equals its body run eagerly on the same
    inputs, bit for bit."""
    for name, (prog, inputs) in card_programs.items():
        assert prog.graph is not None and prog.nodes > 0, name
        got = prog(*inputs)
        want = prog.eager(*[t.clone() for t in inputs])
        assert tree_equal(got, want), name


@pytest.mark.gpu
def test_program_bodies_never_wait_on_the_host(card_programs):
    """torch.cuda.set_sync_debug_mode("error") around one eager run of each
    captured body: none synchronizes with the host."""
    for name, (prog, inputs) in card_programs.items():
        prog.eager(*inputs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog.eager(*inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_program_capture_failure_raises():
    """A body that waits on the host (``.item()``) cannot be captured: the
    call raises, names the program, and returns nothing; nothing falls
    back to an eager run."""
    _need_card()
    from suitesparse_tpu_torch.utils.programs import DeviceProgram
    prog = DeviceProgram("host_wait", ("host_wait", 1),
                         lambda x: x * x.sum().item(), "cuda")
    with pytest.raises(RuntimeError, match="host_wait.*capture failed"):
        prog(torch.ones(8, device="cuda"))
    assert prog.graph is None and not prog.prepared


@pytest.mark.gpu
def test_block_chol_launches_per_replay_and_no_aliasing(tmp_path):
    """The pf program's capture records the plan's count of block_chol
    launches, and every replay adds exactly that many; a second factor
    leaves the first factor's buffer as it was; a replayed factor saves
    and loads like any other."""
    _need_card()
    from chip_smoke import factor_shapes
    from suitesparse_tpu_torch.utils import (load_super_factor,
                                             save_super_factor)
    A = laplacian_3d(12)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    before = kernels.block_chol.launches
    f1 = factorize_super(A, sym, ss, common=cm)
    want = sum(factor_shapes(f1.plan.pf_plan(cm)).values())
    assert want > 0 and kernels.block_chol.launches - before == want
    assert cm.info["factor_capture_time"] > 0
    assert cm.info["factor_graph_nodes"] > want
    keep = f1.Lx.clone()
    A2 = type(A)(A.indptr, A.indices, A.data * 2.0, A.shape)
    before = kernels.block_chol.launches
    f2 = factorize_super(A2, sym, ss, plan=f1.plan, common=cm)
    assert kernels.block_chol.launches - before == want
    assert torch.equal(f1.Lx, keep) and not torch.equal(f1.Lx, f2.Lx)
    save_super_factor(str(tmp_path / "f.npz"), f2)
    back = load_super_factor(str(tmp_path / "f.npz"))
    t = f2.plan.total
    assert back.Lx.device.type == "cuda"
    assert torch.equal(back.Lx[:t], f2.Lx[:t]) and back.minor == f2.minor


@pytest.mark.gpu
def test_two_factors_share_one_captured_solve_program():
    """Two factors of one plan solve alternately (f1, f2, f1) through the
    plan's programs: each captured once (no warm-up or capture for the
    second factor), each solution bit-identical to the solve body run
    eagerly on its own factor's buffers."""
    _need_card()
    from suitesparse_tpu_torch.cholesky.super_numeric import (
        _solve_body, _solve_wave_plan, bind_solve_factor, solve_program)
    from suitesparse_tpu_torch.cholesky.wave import solve_dinv
    A = laplacian_3d(12)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = "pf"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    f1 = factorize_super(A, sym, ss, common=cm)
    A2 = type(A)(A.indptr, A.indices, A.data * 2.0, A.shape)
    f2 = factorize_super(A2, sym, ss, plan=f1.plan, common=cm)
    plan = f1.plan
    b = np.random.default_rng(2).standard_normal((A.ncol, 4))
    graphs = {}
    for f in (f1, f2, f1):
        perm = torch.as_tensor(f.perm, device="cuda")
        for system in ("A", "LLt", "L", "Lt"):
            x = solve_super(f, b, system, cm)
            prog = solve_program(plan, system, 4, torch.float32, "cuda", cm)
            assert prog.graph is not None
            assert graphs.setdefault(system, prog.graph) is prog.graph
            Dv = solve_dinv(_solve_wave_plan(plan, cm), f.Lx)
            own = _solve_body(plan, system, True, cm, f.Lx, Dv, perm,
                              torch.argsort(perm))
            want = own(torch.as_tensor(b, dtype=torch.float32,
                                       device="cuda"))
            assert np.array_equal(x, want.cpu().numpy()), system
        R = bind_solve_factor(f, cm)
        assert R.holds(f)


@pytest.mark.gpu
def test_two_numerics_share_one_captured_umf_solve_program():
    """The same for umf_solve: two numerics of one symbolic, alternately,
    through programs captured once, each triangular solve bit-identical
    to the body run eagerly on its own numeric."""
    _need_card()
    from suitesparse_tpu_torch.lu import umf_numeric, umf_solve, umf_symbolic
    from suitesparse_tpu_torch.lu.multifrontal import (_umf_solve_body,
                                                       umf_solve_program)
    C = cd3d(8)
    cm = default_common()
    S = umf_symbolic(C, cm)
    C2 = type(C)(C.indptr, C.indices, C.data * 1.5, C.shape)
    nums = [umf_numeric(C, S, cm), umf_numeric(C2, S, cm)]
    rng = np.random.default_rng(6)
    graphs = {}
    for i in (0, 1, 0):
        num = nums[i]
        umf_solve(num, rng.standard_normal(C.ncol), "A", refine=0)
        umf_solve(num, rng.standard_normal(C.ncol), "At", refine=0)
        for name in ("lsolve", "usolve", "ltsolve", "utsolve"):
            prog = umf_solve_program(S, name, 1, False, torch.float32, "cuda")
            assert prog.graph is not None
            assert graphs.setdefault(name, prog.graph) is prog.graph
            z = torch.as_tensor(rng.standard_normal((C.ncol, 1)),
                                dtype=torch.float32, device="cuda")
            own = _umf_solve_body(S, name, False, num.Lb, num.Ub, num.pivs)
            assert torch.equal(prog(z), own(z.clone())), name


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 3, 8])
def test_loop_programs_match_the_one_sync_loop_on_the_card(steps):
    """PageRank and BFS programs of 1, 3 and 8 predicated steps on the
    card: the one-sync loop's iteration and its ranks and levels bit for
    bit, with at most ceil(iterations / steps) + 1 host syncs a run once
    the program is captured."""
    _need_card()
    from suitesparse_tpu_torch.graphblas import algorithms as alg
    G = ring_chords(3000, 21)
    dev = torch.device("cuda")
    rows, cols, _ = alg._coo_arrays(G, dev)
    n = G.shape[0]
    outdeg = torch.clamp(torch.bincount(rows, minlength=n).float(), min=1.0)
    w = 1.0 / outdeg[rows]
    for tol, max_iter in ((1e-9, 100), (1e-6, 100), (0.0, 7)):
        r1, it1 = one_sync_pagerank(rows, cols, w, n, tol, max_iter)
        cache = {}
        alg._pagerank_loop(rows, cols, w, n, 0.85, tol, max_iter, steps,
                           cache)
        (r, it), syncs = host_syncs(lambda: alg._pagerank_loop(
            rows, cols, w, n, 0.85, tol, max_iter, steps, cache))
        assert it == it1 and torch.equal(r, r1), (tol, max_iter)
        assert syncs <= -(-it // steps) + 1, (syncs, it)
    level1, depth = one_sync_bfs(rows, cols, n, 0)
    cache = {}
    alg._bfs_loop(rows, cols, n, 0, steps, cache)
    (level, d), syncs = host_syncs(
        lambda: alg._bfs_loop(rows, cols, n, 0, steps, cache))
    assert d == depth and torch.equal(level, level1)
    assert syncs <= -(-d // steps) + 1, (syncs, d)


def _pf_on_card(k):
    """lap3d_k's pf plan and float32 values on the card."""
    from suitesparse_tpu_torch.cholesky.super_numeric import (
        _assemble_values, build_plan)
    A = laplacian_3d(k)
    cm = default_common()
    cm.cholesky.supernodal = "supernodal"
    sym = analyze(A, cm)
    ss = super_symbolic(A, sym, cm)
    pfp = build_plan(ss).pf_plan(cm)
    return pfp, torch.as_tensor(_assemble_values(A, sym, ss, np.float32),
                                device="cuda")


@pytest.mark.gpu
def test_block_chol_launches_of_an_eager_pf_body_land_in_fpotrf():
    """lap3d_16: every block_chol kernel of one profiled eager pf body
    (launched through ctypes, outside any torch operator) is attributed
    to an Fpotrf scope, as many as a replay launches."""
    _need_card()
    from suitesparse_tpu_torch.cholesky.pf import pf_program
    from suitesparse_tpu_torch.tools import profile_attrib
    pfp, vals = _pf_on_card(16)
    prog = pf_program(pfp, np.float32, device="cuda")
    res = profile_attrib.attribute_pf(prog, vals)
    want = prog.per_replay[0]
    cc = res["eager"]["cross_count"]
    assert want > 0 and cc["Fpotrf"].get("block_chol") == want
    assert sum(c.get("block_chol", 0) for c in cc.values()) == want
    assert res["eager"]["attributed_share"] >= 0.95


@pytest.mark.gpu
def test_scopes_leave_the_pf_graph_unchanged(monkeypatch):
    """The pf program captured as shipped (no profiler records during a
    capture, so its ranges are no-ops) and again with every range entered
    through record_function: the same node count, bit-identical replays,
    both equal to the eager body."""
    _need_card()
    from torch.profiler import record_function
    from suitesparse_tpu_torch.cholesky import pf
    pfp, vals = _pf_on_card(16)
    prog = pf.pf_program(pfp, np.float32, device="cuda")
    got = prog(vals)
    monkeypatch.setattr(pf, "_scope", record_function)
    pfp._cache.pop(prog.key)
    ranged = pf.pf_program(pfp, np.float32, device="cuda")
    assert ranged is not prog
    assert torch.equal(ranged(vals), got) and ranged.nodes == prog.nodes > 0
    assert torch.equal(prog.eager(vals), got)


@pytest.mark.gpu
def test_scoped_pf_capture_syncs_nothing(monkeypatch):
    """torch.cuda.set_sync_debug_mode("error") around the pf program's
    warm-up, capture, replay and eager body, every range entered through
    record_function: the ranges wait on nothing."""
    _need_card()
    from torch.profiler import record_function
    from suitesparse_tpu_torch.cholesky import pf
    pfp, vals = _pf_on_card(12)
    monkeypatch.setattr(pf, "_scope", record_function)
    prog = pf.pf_program(pfp, np.float32, device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = prog(vals)
        again = prog(vals)
        eager = prog.eager(vals)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert prog.graph is not None
    assert torch.equal(got, again) and torch.equal(got, eager)


@pytest.mark.gpu
def test_probe_precision_leaves_tf32_off():
    """After the precision probe on the card, float32 products are full
    float32 again and a device program may be captured."""
    _need_card()
    from suitesparse_tpu_torch.tools import probe_precision
    from suitesparse_tpu_torch.utils import programs
    out = probe_precision.main(m=512, reps=2)
    assert out["highest"]["relerr"] < out["high"]["relerr"]
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    programs._check_precision()
