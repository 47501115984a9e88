"""The port's serialization (utils/serialize.py) against the JAX reference:
round trips, and files crossed both ways between the packages -- written
by the reference and loaded by the port, and the other way -- for sparse
matrices, simplicial factors, supernodal factors, GraphBLAS blobs, and
UMFPACK symbolic/numeric and KLU objects.  The format is shared, so every
crossing is exact."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.cholesky as ref_chol
import suitesparse_tpu.lu as ref_lu
from suitesparse_tpu import utils as ref_utils
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.core.status import SparseError as RefError
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
import suitesparse_tpu_torch.lu as port_lu
from suitesparse_tpu_torch import graphblas as port_gb
from suitesparse_tpu_torch import utils as port_utils
from suitesparse_tpu_torch.core.common import default_common as port_common
from suitesparse_tpu_torch.core.sparse import SparseCSC as PortCSC
from suitesparse_tpu_torch.core.status import SparseError as PortError
from suitesparse_tpu_torch.io import generators as port_gen

DIRECTIONS = [("ref", "port"), ("port", "ref"), ("port", "port")]
UTILS = {"ref": ref_utils, "port": port_utils}
GENS = {"ref": ref_gen, "port": port_gen}
CHOL = {"ref": ref_chol, "port": port_chol}
LU = {"ref": ref_lu, "port": port_lu}
COMMON = {"ref": ref_common, "port": port_common}
CSC = {"ref": RefCSC, "port": PortCSC}


def _same_csc(A, B):
    assert tuple(A.shape) == tuple(B.shape) and A.stype == B.stype
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data) and A.data.dtype == B.data.dtype


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("gen", ["random_unsym", "laplacian_2d"])
def test_sparse_crosses_between_packages(tmp_path, src, dst, gen):
    A = (GENS[src].random_unsym(30, 0.1, seed=1) if gen == "random_unsym"
         else GENS[src].laplacian_2d(7))
    UTILS[src].save_sparse(tmp_path / "a.npz", A)
    _same_csc(UTILS[dst].load_sparse(tmp_path / "a.npz"), A)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("ll", [False, True])
def test_simplicial_factor_crosses_between_packages(tmp_path, src, dst, ll):
    A = GENS[src].random_spd(25, 0.15, seed=2)
    f = CHOL[src].factorize_simplicial(A, ll=ll)
    UTILS[src].save_factor(tmp_path / "f.npz", f)
    g = UTILS[dst].load_factor(tmp_path / "f.npz")
    assert isinstance(g, CHOL[dst].Factor)
    for name in ("perm", "Lp", "Li", "Lx"):
        assert np.array_equal(getattr(g, name), getattr(f, name)), name
    assert (g.D is None) == ll and (g.n, g.is_ll, g.minor) == (f.n, ll,
                                                               f.minor)
    b = np.ones(25)
    assert np.array_equal(CHOL[dst].solve(g, b), CHOL[src].solve(f, b))


def _super_factor(pkg, program, dtype):
    cm = (ref_common if pkg == "ref" else port_common)()
    cm.cholesky.supernodal = "supernodal"
    cm.cholesky.program = program
    A = GENS[pkg].laplacian_3d(8)
    sym = CHOL[pkg].analyze(A, cm)
    ss = CHOL[pkg].super_symbolic(A, sym, cm)
    kw = {"device": "cpu"} if pkg == "port" else {}
    return A, CHOL[pkg].factorize_super(A, sym, ss, common=cm, dtype=dtype,
                                        **kw)


def _lx(f):
    return f.Lx.numpy() if isinstance(f.Lx, torch.Tensor) else np.asarray(
        f.Lx)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("program,dtype", [("pf", np.float64),
                                           ("unrolled", np.float32)])
def test_super_factor_crosses_between_packages(tmp_path, src, dst, program,
                                               dtype):
    """The panel buffer, permutation and layout cross exactly; the loaded
    factor solves as the saved one does (the port's on the CPU here, on
    the card by default)."""
    A, f = _super_factor(src, program, dtype)
    UTILS[src].save_super_factor(tmp_path / "sf.npz", f)
    kw = {"device": "cpu"} if dst == "port" else {}
    g = UTILS[dst].load_super_factor(tmp_path / "sf.npz", **kw)
    assert isinstance(g, CHOL[dst].SuperFactor)
    if dst == "port":
        assert g.Lx.device.type == "cpu" and g.Lx.dtype == torch.as_tensor(
            np.zeros(1, dtype)).dtype
    assert np.array_equal(_lx(g), _lx(f)) and np.dtype(g.dtype) == dtype
    assert np.array_equal(g.perm, f.perm) and g.minor == f.minor
    for name in ("panel_off", "panel_Np", "panel_Mp", "super", "sn_rows"):
        assert np.array_equal(getattr(g.plan.ss, name),
                              getattr(f.plan.ss, name)), name
    assert g.plan.meta == f.plan.meta
    b = np.random.default_rng(3).standard_normal(A.ncol)
    x = CHOL[dst].solve_super(g, b)
    assert CHOL[dst].residual_norm(A, x.astype(np.float64), b) < (
        1e-13 if dtype == np.float64 else 1e-5)


def _on_cpu(pkg):
    return {"device": "cpu"} if pkg == "port" else {}


def _umf_case(pkg, case):
    """A seeded matrix of ``pkg`` and its UMF symbolic and numeric: the
    multifrontal path ("unsymmetric" strategy), the BTF/singleton path
    with inner blocks, and complex."""
    cm = COMMON[pkg]()
    if case == "btf":
        A = GENS[pkg].random_unsym(120, 0.03, seed=2)
    else:
        A = GENS[pkg].random_unsym(80, 0.08, seed=1)
        cm.lu.singletons = False
        if case == "complex":
            S = A.to_scipy() + 1j * sp.random(
                80, 80, 0.05, random_state=np.random.default_rng(2)) \
                + 3j * sp.identity(80)
            A = CSC[pkg].from_scipy(sp.csc_matrix(S))
    S = LU[pkg].umf_symbolic(A, cm)
    assert (S.singles is not None) == (case == "btf")
    return A, S, LU[pkg].umf_numeric(A, S, cm, **_on_cpu(pkg))


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("case", ["unsymmetric", "btf", "complex"])
def test_umf_files_cross_between_packages(tmp_path, src, dst, case):
    """A UMF symbolic and numeric saved by one package load in the other
    and solve the same system: every array crosses exactly, and the
    crossed factor's solutions agree within 1e-12 with the saving
    package's."""
    A, S, num = _umf_case(src, case)
    UTILS[src].save_umf_symbolic(tmp_path / "s.npz", S)
    UTILS[src].save_umf_numeric(tmp_path / "n.npz", num)
    S2 = UTILS[dst].load_umf_symbolic(tmp_path / "s.npz")
    assert isinstance(S2, LU[dst].UmfSymbolic)
    assert (S2.n, S2.strategy) == (S.n, S.strategy)
    if S.singles is None:
        for k in ("a_scatter_L", "a_scatter_U", "a_perm_rows",
                  "a_perm_cols", "rowmatch"):
            assert np.array_equal(getattr(S2, k), getattr(S, k)), k
        assert S2.plan.meta == S.plan.meta
    num2 = UTILS[dst].load_umf_numeric(tmp_path / "n.npz", **_on_cpu(dst))
    assert isinstance(num2, LU[dst].UmfNumeric)
    assert num2.singular == num.singular and np.dtype(num2.dtype) == \
        np.dtype(num.dtype)
    if dst == "port":
        assert all(bn is None or bn.Lb.device.type == "cpu"
                   for bn in (num2.bnums or [num2]))
    A2 = CSC[dst](A.indptr, A.indices, A.data, A.shape)
    b = np.random.default_rng(3).standard_normal(A.ncol)
    for system in ("A", "At"):
        x = LU[src].umf_solve(num, b, system, A=A)
        x2 = LU[dst].umf_solve(num2, b, system, A=A2)
        assert np.abs(x2 - x).max() <= 1e-12 * np.abs(x).max(), system
        x = LU[src].umf_solve(num, b, system, refine=0)
        x2 = LU[dst].umf_solve(num2, b, system, refine=0)
        assert np.abs(x2 - x).max() <= 1e-12 * np.abs(x).max(), system
    # and a loaded symbolic refactors the matrix (numeric reuse)
    num3 = LU[dst].umf_numeric(A2, S2, COMMON[dst](), **_on_cpu(dst))
    x3 = LU[dst].umf_solve(num3, b, A=A2)
    assert np.abs(A.to_scipy() @ x3 - b).max() < 1e-10


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("gen", ["circuit_like", "multiblock"])
def test_klu_file_crosses_between_packages(tmp_path, src, dst, gen):
    if gen == "circuit_like":
        A = GENS[src].circuit_like(150, seed=4)
    else:
        rng = np.random.default_rng(6)
        M = sp.triu(sp.random(60, 60, 0.08, random_state=rng), 1) \
            + sp.diags(2.0 + rng.random(60))
        M = M.tolil()
        M[40, 39] = M[20, 18] = 0.7
        A = CSC[src].from_scipy(sp.csc_matrix(M))
    sym = LU[src].klu_analyze(A)
    num = LU[src].klu_factor(A, sym)
    assert (sym.nblocks > 1) == (gen == "multiblock")
    UTILS[src].save_klu(tmp_path / "k.npz", num)
    num2 = UTILS[dst].load_klu(tmp_path / "k.npz")
    assert isinstance(num2, LU[dst].KLUNumeric)
    for k in ("p", "q", "r"):
        assert np.array_equal(getattr(num2.sym, k), getattr(sym, k))
    for k in ("pnum", "Rs", "p_final"):
        assert np.array_equal(getattr(num2, k), getattr(num, k))
    assert (num2.offdiag != num.offdiag).nnz == 0
    for b1, b2 in zip(num.blocks, num2.blocks, strict=True):
        for k in ("Lp", "Li", "Lx", "Up", "Ui", "Ux", "pivot_rows"):
            assert np.array_equal(getattr(b1, k), getattr(b2, k)), k
    b = np.random.default_rng(7).standard_normal(A.ncol)
    for tr in (False, True):
        assert np.array_equal(LU[dst].klu_solve(num2, b, transpose=tr),
                              LU[src].klu_solve(num, b, transpose=tr))


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("method", ["zstd", "zlib", "none"])
def test_matrix_blob_crosses_between_packages(src, dst, method):
    S = sp.random(200, 150, 0.05, random_state=np.random.default_rng(4),
                  format="csc")
    A = (PortCSC if src == "port" else RefCSC).from_scipy(S)
    ser = {"ref": ref_utils.serialize, "port": port_utils.serialize}
    blob = ser[src].matrix_serialize(A, method)
    _same_csc(ser[dst].matrix_deserialize(blob), A)


def test_graphblas_serialize_is_wired():
    A = PortCSC.from_scipy(sp.random(50, 40, 0.1, format="csc",
                                     random_state=np.random.default_rng(5)))
    assert port_gb.matrix_serialize is port_utils.matrix_serialize
    _same_csc(port_gb.matrix_deserialize(port_gb.matrix_serialize(A)), A)
    P = PortCSC(A.indptr, A.indices, None, A.shape)
    Q = port_gb.matrix_deserialize(port_gb.matrix_serialize(P, "zlib"))
    assert Q.data is None and np.array_equal(Q.indices, P.indices)


def test_wrong_kind_and_bad_blob_are_refused(tmp_path):
    A = port_gen.random_spd(10, 0.3, seed=4)
    port_utils.save_sparse(tmp_path / "a.npz", A)
    for utils, err in ((port_utils, PortError), (ref_utils, RefError)):
        with pytest.raises(err):
            utils.load_factor(tmp_path / "a.npz")
        with pytest.raises(err):
            utils.load_super_factor(tmp_path / "a.npz")
        with pytest.raises(err):
            utils.load_klu(tmp_path / "a.npz")
        with pytest.raises(err):
            utils.load_umf_symbolic(tmp_path / "a.npz")
        with pytest.raises(err):
            utils.load_umf_numeric(tmp_path / "a.npz", **(
                {"device": "cpu"} if utils is port_utils else {}))
    with pytest.raises(PortError):
        port_utils.matrix_deserialize(
            len(b"{}").to_bytes(8, "little") + b"{}")
    with pytest.raises(PortError):
        port_utils.matrix_serialize(A, "lz4")
