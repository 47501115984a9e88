"""The arithmetic of the bcsr_spmm kernel's 3xTF32 products, rehearsed on
the CPU in plain PyTorch (the kernel itself runs only on the card).

``split`` below is the kernel's ``split_any`` (csrc/bcsr_spmm.cu) written
with bit masks: hi is v truncated to TF32, lo = v - hi truncated to TF32,
and for a v that is not finite lo = 0, the cross terms take 0 for hi, and
hi is v + hi.  (For finite values the kernel's cheaper ``split`` gives the
same hi and lo.)  A TF32 value has 11 significant bits, so the product of
two is exact in float32, and a float32 batched product of TF32 values is
what the kernel's wgmma steps compute, up to the order of the sum."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from suitesparse_tpu_torch.core.sparse import SparseCSC
from suitesparse_tpu_torch.ops import spmv
from suitesparse_tpu_torch.tools.bench_bcsr import inf_nan_case

MASK = -8192          # 0xffffe000 as int32: TF32 keeps 10 mantissa bits
RCASES = ((90, 100, 0.3, 1), (128, 128, 0.2, 50), (1000, 700, 0.01, 1),
          (1000, 700, 0.01, 50), (1000, 700, 0.01, 130),
          (700, 1100, 0.0001, 7), (3000, 2500, 0.002, 64),
          (1000, 700, 0.01, 32), (600, 900, 0.02, 128),
          (500, 400, 0.03, 256))


def _bits(v):
    return v.contiguous().view(torch.int32)


def _float(b):
    return b.contiguous().view(torch.float32)


def split(v: torch.Tensor):
    """(hi, lo, hic) of float32 v, as the kernel forms them."""
    h = _float(_bits(v) & MASK)
    lo = v - h
    finite = lo == lo
    hi = torch.where(finite, h, v + h)
    lo = torch.where(finite, _float(_bits(lo) & MASK), torch.zeros_like(v))
    hic = torch.where(finite, h, torch.zeros_like(v))
    return hi, lo, hic


def emulated(blocks, block_cols, X, nslots, shape, terms=3):
    """bcsr_spmm_plain's product with every a*x taken as the kernel takes
    it: a_lo*x_hic + a_hic*x_lo + a_hi*x_hi (terms=3), or plain TF32,
    a_hi*x_hi alone (terms=1)."""
    nb, bm, bk = blocks.shape
    nrb = nb // nslots
    m, n = shape
    k = X.shape[1]
    ncb = -(-n // bk)
    Xp = X.new_zeros((ncb * bk, k))
    Xp[:n] = X
    ah, al, ac = split(blocks)
    xh, xl, xc = split(Xp)
    cols = block_cols.view(nrb, nslots).long()
    out = X.new_zeros((nrb, bm, k))

    def part(a, x, t):
        return torch.bmm(a.view(nrb, nslots, bm, bk)[:, t],
                         x.view(ncb, bk, k)[cols[:, t]])

    for t in range(nslots):
        if terms == 3:
            out += part(al, xc, t) + part(ac, xl, t)
        out += part(ah, xh, t)
    return out.reshape(nrb * bm, k)[:m]


def _case(rng, m, n, d, k):
    S = sp.random(m, n, d, random_state=rng, format="csc",
                  dtype=np.float64)
    bc = spmv.to_bcsr(SparseCSC.from_scipy(S))
    X = rng.standard_normal((n, k)).astype(np.float32)
    return S, bc, X


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_split_parts_and_classes():
    """hi + lo rebuilds every normal float32 to 2^-20 relative, hi never
    rounds a finite value up to Inf, and the classes are kept: hi is Inf
    for Inf and NaN for every NaN (a payload in the low bits included),
    lo and hic are 0 for both."""
    big = np.finfo(np.float32).max
    tiny = np.finfo(np.float32).tiny
    v = np.array([0.0, -0.0, 1.0, -3.5, 1 + 2 ** -23, np.pi, big, -big,
                  tiny, tiny / 3, 6.0, -1.0, 1e-30, 7.3e20],
                 dtype=np.float32)
    rng = np.random.default_rng(0)
    v = np.concatenate([v, rng.standard_normal(4096)
                        * 10.0 ** rng.integers(-30, 30, 4096)]
                       ).astype(np.float32)
    hi, lo, hic = split(torch.as_tensor(v))
    assert torch.isfinite(hi).all() and torch.equal(hi, hic)
    assert (hi.abs() <= torch.as_tensor(v).abs()).all()
    for part in (hi, lo):   # both are TF32 values
        assert not (_bits(part) & 0x1FFF).any()
    err = np.abs(hi.double().numpy() + lo.double().numpy()
                 - v.astype(np.float64))
    # relative to v, or to the TF32 spacing of subnormal lo parts
    assert (err <= 2.0 ** -20 * np.abs(v) + 2.0 ** -136).all()
    special = torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32)
    payload = _float(torch.tensor([0x7F800001, -8388607],  # 0xff800001
                                  dtype=torch.int32))
    hi, lo, hic = split(torch.cat([special, payload]))
    assert hi[0] == np.inf and hi[1] == -np.inf
    assert torch.isnan(hi[2:]).all()
    assert torch.isnan(_float(_bits(hi[2:]) & MASK)).all()  # survives TF32
    assert not lo.any() and not hic.any()


@pytest.mark.parametrize("m,n,d,k", RCASES)
def test_emulated_3xtf32_matches_plain(m, n, d, k):
    """On seeded random BCSR (values not exact in TF32, so a_lo != 0) the
    emulated kernel is within 1e-5 of the plain version and of scipy in
    float64, the kernel's tolerances; plain TF32 on the same inputs is
    not, so the check tells the two apart."""
    rng = np.random.default_rng(m + n + k)
    S, bc, Xh = _case(rng, m, n, d, k)
    blocks, cols = bc.device_arrays(torch.device("cpu"))
    X = torch.as_tensor(Xh)
    assert bool((split(blocks)[1] != 0).any())
    Y = emulated(blocks, cols, X, bc.nslots, bc.shape)
    P = spmv.bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
    ref = S @ Xh.astype(np.float64)
    assert Y.shape == (m, k)
    assert _rel(Y.numpy(), P.numpy()) <= 1e-5
    assert _rel(Y.numpy(), ref) <= 1e-5
    if d >= 0.01:   # enough terms a row for TF32's error to show
        T = emulated(blocks, cols, X, bc.nslots, bc.shape, terms=1)
        assert _rel(T.numpy(), ref) > 1e-5


def test_emulated_inf_nan_pattern_matches_plain():
    """The emulated kernel's isnan and isinf patterns equal the plain
    version's, with Inf and NaN in A, in X and in X's block 0."""
    bc, Xh = inf_nan_case(np.random.default_rng(11))
    assert (bc.blocks.reshape(bc.nrb, bc.nslots, -1) == 0).all(2).any()
    blocks, cols = bc.device_arrays(torch.device("cpu"))
    X = torch.as_tensor(Xh)
    Y = emulated(blocks, cols, X, bc.nslots, bc.shape)
    P = spmv.bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
    assert torch.isnan(P).any() and torch.isinf(P).any()
    assert torch.isfinite(P).any()
    assert torch.equal(torch.isnan(Y), torch.isnan(P))
    assert torch.equal(torch.isinf(Y), torch.isinf(P))
    assert torch.equal(torch.sign(Y[torch.isinf(Y)]),
                       torch.sign(P[torch.isinf(P)]))
