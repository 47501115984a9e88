"""The port's serialization (utils/serialize.py) against the JAX reference:
round trips, and files crossed both ways between the packages -- written
by the reference and loaded by the port, and the other way -- for sparse
matrices, simplicial factors, supernodal factors and GraphBLAS blobs.
The format is shared, so every crossing is exact."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import suitesparse_tpu.cholesky as ref_chol
from suitesparse_tpu import utils as ref_utils
from suitesparse_tpu.core.common import default_common as ref_common
from suitesparse_tpu.core.sparse import SparseCSC as RefCSC
from suitesparse_tpu.core.status import SparseError as RefError
from suitesparse_tpu.io import generators as ref_gen

import suitesparse_tpu_torch.cholesky as port_chol
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
    with pytest.raises(PortError):
        port_utils.matrix_deserialize(
            len(b"{}").to_bytes(8, "little") + b"{}")
    with pytest.raises(PortError):
        port_utils.matrix_serialize(A, "lz4")
