"""The port's sparse products (suitesparse_tpu_torch/ops, models/ssmult)
against the JAX reference on the same seeded inputs, on the CPU.

Host plans (BCSR, SpGEMM, row programs) must be identical to the
reference's.  Numeric results: float64 to 1e-12 relative (the same terms,
summed in another order by another backend), integers and bools exactly.
The BCSR product is float32 by definition in both packages: 1e-5 relative,
since both sum up to 128 * nslots products in float32 in another order.
The reference's Pallas BCSR kernel runs in interpret mode; the port's
``bcsr_spmm`` runs its plain version on a CPU tensor (the CUDA kernel is
held against that plain version by test_torch_gpu.py).
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu_torch.core.sparse import SparseCSC

# the packages' __init__ re-export functions named like these modules
# (ops.spgemm, models.ssmult), so the modules are fetched by name
ref_mult = importlib.import_module("suitesparse_tpu.models.ssmult")
ref_host = importlib.import_module("suitesparse_tpu.ops.host")
ref_spgemm = importlib.import_module("suitesparse_tpu.ops.spgemm")
ref_spmv = importlib.import_module("suitesparse_tpu.ops.spmv")
port_mult = importlib.import_module("suitesparse_tpu_torch.models.ssmult")
port_host = importlib.import_module("suitesparse_tpu_torch.ops.host")
port_spgemm = importlib.import_module("suitesparse_tpu_torch.ops.spgemm")
port_spmv = importlib.import_module("suitesparse_tpu_torch.ops.spmv")

CPU = "cpu"


def _pair(S):
    """The same scipy matrix as a reference and a port SparseCSC."""
    S = sp.csc_matrix(S)
    return RefCSC.from_scipy(S), SparseCSC.from_scipy(S)


def _rand(m, n, d, seed, lo=0.5, hi=1.5):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, d, random_state=rng, format="csc")
    S.data[:] = rng.uniform(lo, hi, len(S.data))
    return S


def _close(got, want, rtol=1e-12):
    """float: max |got - want| <= rtol * max |want| (infinities equal);
    integer and bool: exact, same dtype."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "biu":
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert np.array_equal(got, want)
        return
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    inf = np.isinf(want)
    assert np.array_equal(np.isinf(got), inf)
    assert np.array_equal(got[inf], want[inf])
    g, w = got[~inf], want[~inf]
    if w.size:
        assert np.abs(g - w).max() <= rtol * max(np.abs(w).max(), 1e-300)


def _same_csc(got, want, rtol=1e-12):
    """Same pattern (indptr, indices) and values as the reference's."""
    assert got.shape == want.shape
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    _close(got.data, want.data, rtol)


# -- BCSR ------------------------------------------------------------------

BCSR_CASES = {
    # test_spgemm.py's case: 400 x 330 at 2%, k = 50
    "spgemm_case": (400, 330, 0.02, 50, 20),
    # uneven rows: most block rows hold fewer blocks than nslots (pad slots)
    "pad_slots": (700, 1100, 0.0001, 7, 21),
    "one_block": (90, 100, 0.3, 1, 22),
    "wide_k": (260, 300, 0.01, 130, 23),
}


def _bcsr_input(m, n, d, k, seed):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, d, random_state=rng, format="csc")
    X = rng.standard_normal((n, k))
    return S, X


@pytest.mark.parametrize("case", sorted(BCSR_CASES))
def test_to_bcsr_identical(case):
    S, _ = _bcsr_input(*BCSR_CASES[case])
    ra, pa = _pair(S)
    want, got = ref_spmv.to_bcsr(ra), port_spmv.to_bcsr(pa)
    assert np.array_equal(got.blocks, want.blocks)
    assert got.blocks.dtype == want.blocks.dtype == np.float32
    assert np.array_equal(got.block_cols, want.block_cols)
    assert got.block_cols.dtype == want.block_cols.dtype
    assert (got.nrb, got.nslots, got.bm, got.bk, got.shape) == \
        (want.nrb, want.nslots, want.bm, want.bk, want.shape)


def test_bcsr_cases_have_pad_slots():
    """The pad-slot case really has rows padded with zero blocks."""
    S, _ = _bcsr_input(*BCSR_CASES["pad_slots"])
    bc = port_spmv.to_bcsr(SparseCSC.from_scipy(S))
    per_row = (np.abs(bc.blocks).reshape(bc.nrb, bc.nslots, -1).max(2) > 0
               ).sum(1)
    assert per_row.min() < bc.nslots


@pytest.mark.parametrize("case", sorted(BCSR_CASES))
def test_bcsr_spmm_plain_matches_reference(case):
    """Port plain BCSR product, on the reference's own BCSR (adopted
    through bcsr_from_numpy) and on the port's, vs the reference's Pallas
    kernel in interpret mode; float32, 1e-5 relative."""
    S, X = _bcsr_input(*BCSR_CASES[case])
    ra, pa = _pair(S)
    rbc = ref_spmv.to_bcsr(ra)
    want = np.asarray(ref_spmv.bcsr_spmm(rbc, X, interpret=True))
    adopted = port_spmv.bcsr_from_numpy(rbc.blocks, rbc.block_cols,
                                        rbc.nslots, rbc.shape)
    own = port_spmv.to_bcsr(pa)
    Xt = torch.from_numpy(X)
    before = port_spmv.bcsr_spmm.launches
    for bc in (adopted, own):
        blocks, cols = bc.device_arrays(torch.device(CPU))
        plain = port_spmv.bcsr_spmm_plain(blocks, cols, Xt.float(),
                                          bc.nslots, bc.shape).numpy()
        entry = port_spmv.bcsr_spmm(bc, Xt).numpy()     # CPU tensor: plain
        for got in (plain, entry):
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert port_spmv.bcsr_spmm.launches == before       # no kernel on CPU
    ref = S.toarray() @ X
    assert np.abs(entry - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bcsr_spmm_host_input_takes_device():
    """numpy X goes to the requested device; the result is a tensor."""
    S, X = _bcsr_input(*BCSR_CASES["spgemm_case"])
    bc = port_spmv.to_bcsr(SparseCSC.from_scipy(S))
    Y = port_spmv.bcsr_spmm(bc, X, device=CPU)
    assert isinstance(Y, torch.Tensor) and Y.device.type == CPU
    assert tuple(Y.shape) == (400, 50) and Y.dtype == torch.float32


@pytest.mark.parametrize("bad", ["dtype", "cols_range", "slots", "shape"])
def test_bcsr_from_numpy_checks(bad):
    S, _ = _bcsr_input(*BCSR_CASES["spgemm_case"])
    bc = ref_spmv.to_bcsr(RefCSC.from_scipy(S))
    blocks, cols, nslots, shape = (bc.blocks, bc.block_cols, bc.nslots,
                                   bc.shape)
    if bad == "dtype":
        blocks = blocks.astype(np.float64)
    elif bad == "cols_range":
        cols = cols.copy()
        cols[0] = 3                       # 330 columns -> blocks 0..2
    elif bad == "slots":
        nslots = blocks.shape[0] + 1
    else:
        shape = (bc.nrb * 128 + 1, shape[1])
    with pytest.raises(ValueError):
        port_spmv.bcsr_from_numpy(blocks, cols, nslots, shape)


# -- SpGEMM plans ----------------------------------------------------------

def _mask(m, n, d, seed):
    return (sp.random(m, n, d, random_state=np.random.default_rng(seed))
            != 0).tocsc().astype(float)


PLAN_CASES = {
    "plain": lambda: (_rand(30, 26, 0.15, 1), _rand(26, 24, 0.18, 2),
                      None, False),
    "masked": lambda: (_rand(40, 35, 0.12, 3), _rand(35, 38, 0.12, 4),
                       _mask(40, 38, 0.2, 5), False),
    "complement": lambda: (_rand(25, 25, 0.15, 6), _rand(25, 25, 0.15, 7),
                           _mask(25, 25, 0.3, 8), True),
    "empty": lambda: (sp.csc_matrix((6, 5)), _rand(5, 4, 0.5, 9), None,
                      False),
    "mask_kills_all": lambda: (_rand(10, 10, 0.3, 10), _rand(10, 10, 0.3, 11),
                               sp.csc_matrix((10, 10)), False),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_spgemm_plan_identical(case):
    A, B, M, comp = PLAN_CASES[case]()
    (ra, pa), (rb, pb) = _pair(A), _pair(B)
    rm, pm = _pair(M) if M is not None else (None, None)
    want = ref_spgemm.spgemm_plan(ra, rb, mask=rm, complement=comp)
    got = port_spgemm.spgemm_plan(pa, pb, mask=pm, complement=comp)
    for f in ("ea", "eb", "seg", "out_rows", "out_cols"):
        w, g = getattr(want, f), getattr(got, f)
        assert np.array_equal(g, w), f
        assert g.dtype == w.dtype, f
    assert (got.nnz, got.shape, got.flops) == (want.nnz, want.shape,
                                               want.flops)
    # and the product over the plan
    if got.nnz:
        _close(port_spgemm.spgemm_apply(got, pa.data, pb.data,
                                        "plus_times", device=CPU).numpy(),
               np.asarray(ref_spgemm.spgemm_apply(want, ra.data, rb.data,
                                                  "plus_times")))


def test_spgemm_device_maps_cached_per_device():
    A = _rand(20, 20, 0.2, 12)
    pa = SparseCSC.from_scipy(A)
    plan = port_spgemm.cached_plan(pa, pa)
    assert port_spgemm.cached_plan(pa, pa) is plan
    maps = plan.device_maps(torch.device(CPU))
    assert plan.device_maps(torch.device(CPU)) is maps
    assert all(t.device.type == CPU for t in maps)
    assert port_spgemm.pattern_key(pa) == ref_spgemm.pattern_key(
        RefCSC.from_scipy(A))


def test_row_program_identical():
    ra, pa = _pair(_with_empty_rows())
    want, got = ref_spmv._row_program(ra), port_spmv._row_program(pa)
    for f in ("rows", "cols", "gat"):
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f)))
    assert (got.m, got.n) == (want.m, want.n)


# -- the semiring sweep (test_spgemm.py:52-92), port vs reference --------

SWEEP_A = _rand(30, 26, 0.15, 1)
SWEEP_B = _rand(26, 24, 0.18, 2)
MONOID_LIST = ["plus", "times", "min", "max", "lor", "land", "any"]
MULT_LIST = ["times", "plus", "min", "max", "first", "second", "pair", "div"]
# the reference catalog's other binops (a literal list: registrations made
# by other tests must not change what is collected)
OTHER_BINOPS = ["minus", "rminus", "rdiv", "land", "lor", "lxor", "band",
                "bor", "bxor", "eq", "ne", "gt", "lt", "ge", "le"]
SWEEP = ([f"{m}_{b}" for m in MONOID_LIST for b in MULT_LIST]
         + [f"plus_{b}" for b in OTHER_BINOPS])


@pytest.mark.parametrize("ring", SWEEP)
def test_semiring_sweep_matches_reference(ring):
    A, B = SWEEP_A, SWEEP_B
    if ring.partition("_")[2] in ("band", "bor", "bxor"):
        # bitwise ops are integer-typed: sweep them on int32 copies
        A = sp.csc_matrix(A.toarray().astype(np.int32))
        B = sp.csc_matrix(B.toarray().astype(np.int32))
    (ra, pa), (rb, pb) = _pair(A), _pair(B)
    want = ref_spgemm.spgemm(ra, rb, ring)
    got = port_spgemm.spgemm(pa, pb, ring, device=CPU)
    _same_csc(got, want)


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "bor_band",
                                  "lxor_lor", "max_div", "times_minus"])
def test_int32_semirings_stay_integer(ring):
    """Integer semirings keep int32 (and div turns to float as in JAX)."""
    rng = np.random.default_rng(30)
    A = _rand(16, 16, 0.3, 31)
    A.data[:] = rng.integers(1, 9, A.nnz)
    A = sp.csc_matrix(A.toarray().astype(np.int32))
    ra, pa = _pair(A)
    want = ref_spgemm.spgemm(ra, ra, ring)
    got = port_spgemm.spgemm(pa, pa, ring, device=CPU)
    _same_csc(got, want)


@pytest.mark.parametrize("complement", [False, True])
def test_masked_spgemm_matches_reference(complement):
    A, B = _rand(40, 35, 0.12, 3), _rand(35, 38, 0.12, 4)
    M = _mask(40, 38, 0.2, 5)
    (ra, pa), (rb, pb), (rm, pm) = _pair(A), _pair(B), _pair(M)
    for ring in ("plus_times", "min_plus"):
        want = ref_spgemm.spgemm(ra, rb, ring, mask=rm, complement=complement)
        got = port_spgemm.spgemm(pa, pb, ring, mask=pm,
                                 complement=complement, device=CPU)
        _same_csc(got, want)


# -- segment programs (spmv_program / spmm_program) ------------------------

def _with_empty_rows():
    A = _rand(50, 40, 0.1, 16)
    A = A.tolil()
    A[[3, 17, 49], :] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times",
                                  "times_plus", "lor_land", "land_lor",
                                  "lxor_first", "any_second", "plus_pair"])
def test_spmv_program_matches_reference(ring):
    """Empty rows keep the reference's fills: 0 (plus), 1 (times), +inf
    (min), -inf (max), and the logical monoids' values."""
    A = _with_empty_rows()
    ra, pa = _pair(A)
    x = np.random.default_rng(17).uniform(-1.5, 1.5, 40)
    want = np.asarray(ref_spmv.spmv_program(ra)(ra.data, x, ring))
    run = port_spmv.spmv_program(pa, device=CPU)
    got = run(pa.data, x, ring)
    assert isinstance(got, torch.Tensor)
    _close(got.numpy(), want)
    assert np.array_equal(run.rows_with_entries.numpy(),
                          np.asarray(ref_spmv.spmv_program(ra)
                                     .rows_with_entries))


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_first"])
def test_spmm_program_matches_reference(ring):
    A = _with_empty_rows()
    ra, pa = _pair(A)
    X = np.random.default_rng(19).standard_normal((40, 7))
    want = np.asarray(ref_spmv.spmm_program(ra)(ra.data, X, ring))
    got = port_spmv.spmm_program(pa, device=CPU)(pa.data, X, ring).numpy()
    _close(got, want)


def test_spmv_program_int_values():
    A = _with_empty_rows()
    A.data[:] = np.arange(1, A.nnz + 1)
    A = sp.csc_matrix(A.toarray().astype(np.int32))
    ra, pa = _pair(A)
    x = np.arange(40, dtype=np.int32) % 5
    for ring in ("plus_times", "min_plus", "max_times", "bor_band"):
        want = np.asarray(ref_spmv.spmv_program(ra)(ra.data, x, ring))
        got = port_spmv.spmv_program(pa, device=CPU)(pa.data, x, ring)
        _close(got.numpy(), want)


# -- models/ssmult ---------------------------------------------------------

@pytest.mark.parametrize("at,bt", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_ssmult_matches_reference(at, bt):
    A, B = _rand(30, 30, 0.1, 40), _rand(30, 30, 0.12, 41)
    (ra, pa), (rb, pb) = _pair(A), _pair(B)
    _same_csc(port_mult.ssmult(pa, pb, at=at, bt=bt, device=CPU),
              ref_mult.ssmult(ra, rb, at=at, bt=bt))


@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_sfmult_matches_reference(at, k):
    A = _rand(30, 24, 0.15, 42)
    ra, pa = _pair(A)
    rng = np.random.default_rng(43)
    rows = 30 if at else 24
    X = rng.standard_normal(rows) if k == 0 else rng.standard_normal((rows, k))
    want = ref_mult.sfmult(ra, X, at=at)
    got = port_mult.sfmult(pa, X, at=at, device=CPU)
    assert isinstance(got, np.ndarray)
    _close(got, np.asarray(want))


# -- ops/host and SparseCSC.__matmul__ ------------------------------------

def test_host_ops_match_reference():
    A, B = _rand(20, 15, 0.2, 50), _rand(15, 12, 0.25, 51)
    (ra, pa), (rb, pb) = _pair(A), _pair(B)
    X = np.random.default_rng(52).standard_normal((15, 3))
    Y = np.random.default_rng(53).standard_normal((20, 3))
    _same_csc(port_host.ssmult(pa, pb), ref_host.ssmult(ra, rb))
    _close(port_host.sdmult(pa, X, alpha=2.0, beta=0.5, Y=Y),
           ref_host.sdmult(ra, X, alpha=2.0, beta=0.5, Y=Y))
    _close(port_host.sdmult(pa, Y, transpose=True),
           ref_host.sdmult(ra, Y, transpose=True))
    s = np.random.default_rng(54).uniform(1, 2, 20)
    for mode, v in (("row", s), ("scalar", 3.0)):
        _same_csc(port_host.scale(pa, v, mode), ref_host.scale(ra, v, mode))
    sq = _pair(_rand(15, 15, 0.3, 55))
    s15 = s[:15]
    for mode in ("col", "sym"):
        _same_csc(port_host.scale(sq[1], s15, mode),
                  ref_host.scale(sq[0], s15, mode))


def test_matmul_routes_through_host_ops():
    """A @ B and A @ X give the reference's results, through ops.host."""
    A, B = _rand(20, 15, 0.2, 60), _rand(15, 12, 0.25, 61)
    (ra, pa), (rb, pb) = _pair(A), _pair(B)
    X = np.random.default_rng(62).standard_normal((15, 4))
    _same_csc(pa @ pb, ra @ rb)
    _close(pa @ X, ra @ X)
    from suitesparse_tpu_torch.core.status import SparseError
    with pytest.raises(SparseError):
        pa @ pa
